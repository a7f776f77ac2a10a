"""Scenario harness: the BASELINE.json configurations as runnable configs.

One registry entry per BASELINE scenario (BASELINE.json `configs`), each
returning a config + runner. `run_scenario(name)` integrates, writes NetCDF
output and a JSONL metrics log, and returns the trajectory — the framework's
equivalent of the reference's per-example CI jobs, with observability wired
in (SURVEY.md §5).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from cloudy_tpu.spec import Family, SpectrumSpec
from cloudy_tpu import kernels as K
from cloudy_tpu.coalescence import build_coalescence_data
from cloudy_tpu.models import box, rainshaft as rs
from cloudy_tpu.utils import io, metrics


def _scenario_box_single_gamma():
    """BASELINE configs[0]: 0-D box, single gamma, Golovin kernel, 3 moments."""
    spec = SpectrumSpec((Family.GAMMA,))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (np.inf,), norms=norms)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=120.0, dt=1.0)
    rhs = jax.jit(box.make_box_rhs(config, coal_data=data))
    mom0 = jnp.asarray([1e8, 1e-2, 2e-12])

    def run():
        return box.run_box(config, rhs, mom0)

    return {
        "spec": spec,
        "config": config,
        "run": run,
        "kind": "box",
        "data": data,
        "mom0": mom0,
    }


def _scenario_box_exp_gamma_mixture():
    """BASELINE configs[1]: 0-D box, exponential+gamma mixture, 5 prognostic
    moments, constant + linear kernel (summed tensor), finite threshold."""
    spec = SpectrumSpec((Family.EXPONENTIAL, Family.GAMMA))
    norms = (1e6, 1e-9)
    # constant rate chosen so 1/(B·M0) ≈ 50 s — stable at dt = 1 s
    const = K.CoalescenceTensor.from_function(K.ConstantKernelFunction(2e-10), 1, 1e-6)
    lin = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    combined = K.CoalescenceTensor(const.array + lin.array)
    data = build_coalescence_data(spec, combined, (5e-10, np.inf), norms=norms)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=120.0, dt=1.0)
    rhs = jax.jit(box.make_box_rhs(config, coal_data=data))
    mom0 = jnp.asarray([1e8, 1e-2, 1.0, 1e-8, 2e-16])

    def run():
        return box.run_box(config, rhs, mom0)

    return {
        "spec": spec,
        "config": config,
        "run": run,
        "kind": "box",
        "data": data,
        "mom0": mom0,
    }


def _scenario_box_long_numerical():
    """BASELINE configs[2]: 0-D box, Long kernel via numerical quadrature,
    two-mode closure with parameter inversion."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    kf = K.LongKernelFunction(5.236e-10, 9.44e9, 5.78)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=60.0, dt=2.0)
    rhs = jax.jit(box.make_box_rhs(config, kernel_func=kf, numerical=True))
    mom0 = jnp.asarray([1e7, 1e-3, 2e-13, 1e5, 1e-4, 2e-13])

    def run():
        return box.run_box(config, rhs, mom0)

    return {"spec": spec, "config": config, "run": run, "kind": "box"}


def _scenario_rainshaft_128():

    """BASELINE configs[3]: 1-D rainshaft, 128 levels, coalescence + upwind
    sedimentation."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=norms)
    config = rs.RainshaftConfig(
        spec=spec, nz=128, zmax=3000.0, norms=norms, t_end=300.0, dt=1.0,
        save_every=30,
    )
    rhs = jax.jit(rs.make_rainshaft_rhs(config, data))
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)

    def run():
        return rs.run_rainshaft(config, rhs, ic)

    return {
        "spec": spec,
        "config": config,
        "run": run,
        "kind": "rainshaft",
        "data": data,
        "ic": ic,
    }


#: pod-scenario production variants (every production configuration gets
#: the pod treatment, not just fixed-threshold 2-gamma). Each entry:
#: (families, thresholds, moving, extra build_coalescence_data kwargs).
POD_VARIANTS = {
    "fixed2gamma": (
        (Family.GAMMA, Family.GAMMA), (5e-10, np.inf), False, {},
    ),
    "moving": (
        (Family.GAMMA, Family.GAMMA), (0.9, 1.0), True, {},
    ),
    "lognorm": (
        (Family.LOGNORMAL, Family.GAMMA), (5e-10, np.inf), False,
        {"lognorm_gl_nodes": 16},
    ),
}


#: the pod scenarios' steps (`_scenario_pod_ensemble(step=...)`): "fused" is
#: the production whole-step kernel on the level-major state;
#: "reference" the AoS XLA path (`make_rainshaft_rhs` + SSPRK33), the f64
#: reference step.
POD_STEPS = ("fused", "reference")


def pod_data(variant: str):
    """(spec, CoalescenceData) of a pod variant at its production tier:
    exact F2 factorization + proven-bound GL incomplete gamma (+ the
    Halley/GL percentile inverse for moving, the GL-16 window rule for
    lognormal); tests/test_golden.py gates the flagship at 1e-3 against
    the stored f64 reference-parity trajectories, tests/test_special.py
    pins the special-function bounds."""
    fams, thresholds, moving, data_kw = POD_VARIANTS[variant]
    spec = SpectrumSpec(fams)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, thresholds, norms=(1e6, 1e-9), moving=moving,
        fast_tier=True, **data_kw,
    )
    return spec, data


def pod_config(spec, nz: int = 32):
    return rs.RainshaftConfig(
        spec=spec, nz=nz, zmax=3000.0, norms=(1e6, 1e-9), t_end=120.0, dt=1.0
    )


def pod_initial_condition(config, second_mode: bool = False):
    """``[nz, n_tot]`` pod column: the rainshaft top-hat in the first mode;
    the second mode empty, or seeded at a tenth of the first's amplitudes
    with ``second_mode`` (as the parity tests do: an empty mode's rows hold
    only self-collision promotion dust, whose knife-edge selects make a
    row-scaled comparison one of noise)."""
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic2 = (
        rs.initial_condition(config.z, [1e7, 1e-3, 2e-13])
        if second_mode
        else np.zeros_like(ic1)
    )
    return np.concatenate([ic1, ic2], axis=-1)


def ensemble_state(ic, n_cols: int, step: str, sharding=None, spread=None,
                   dtype=jnp.float32):
    """The ensemble state of `n_cols` copies of the column `ic` [nz, n_tot]
    in `step`'s layout (level-major ``[n_tot, nz, C]`` for "fused", AoS
    ``[C, nz, n_tot]`` for "reference"), built on the devices shard by shard
    (no host or single-device copy of the whole state). ``spread=(lo, hi)``
    scales column c by ``lo + (hi − lo)·c/(C − 1)``."""
    fused = step == "fused"
    col = jnp.asarray(rs.to_soa(ic[None]) if fused else ic[None], dtype)

    def build(col):
        shape = (*col.shape[:-1], n_cols) if fused else (n_cols, *col.shape[1:])
        y = jnp.broadcast_to(col, shape)
        if spread is not None:
            s = jnp.linspace(spread[0], spread[1], n_cols, dtype=dtype)
            y = y * (s if fused else s[:, None, None])
        return y

    return jax.jit(build, out_shardings=sharding)(col)


def _scenario_pod_ensemble(
    n_columns: int = 1 << 20,
    variant: str = "fixed2gamma",
    step: str = "fused",
    devices=None,
    interpret: bool = False,
):
    """BASELINE configs[4]: a column ensemble sharded over a pure-columns
    mesh of `devices` (default: every device present).

    `step` chooses the step (POD_STEPS): "fused" runs the production path,
    one whole SSPRK33 step as one Triton kernel over the level-major state
    (closure → coalescence → sedimentation → stencil → RK per column, the
    levels in an in-kernel loop); "reference" the AoS XLA path with the
    same physics. ``interpret=True`` runs the kernel in the Pallas
    interpreter (CPU).
    `variant` selects the production configuration (POD_VARIANTS):
    fixed-threshold 2-gamma (the flagship), MovingThreshold 2-gamma
    (percentile thresholds inverted per column per stage, reference
    Coalescence.jl:152-185), or lognormal+gamma on the recentered-window
    rule (ParticleDistributions.jl:614-625)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cloudy_tpu.parallel.mesh import make_mesh
    from cloudy_tpu.parallel.ensemble import (
        ensemble_rainshaft_step,
        ensemble_whole_step,
    )

    if step not in POD_STEPS:
        raise ValueError(f"step={step!r} is not one of {POD_STEPS}")
    spec, data = pod_data(variant)
    config = pod_config(spec)
    nz = config.nz
    mesh = make_mesh(("columns",), devices=devices)
    n_dev = mesh.size
    n_cols = max(n_columns // n_dev, 1) * n_dev

    if step == "fused":
        from cloudy_tpu.ops import triton_coalescence as tc

        whole = tc.make_triton_rainshaft_step_fn(
            data, config.vel, config.norms, nz=nz, dz=config.dz,
            dt=config.dt, interpret=interpret,
        )
        step_fn = ensemble_whole_step(whole, mesh)
        sharding = NamedSharding(mesh, P(None, None, "columns"))
        to_aos = rs.from_soa

        def profile(y):
            return y.mean(axis=2).T
    else:
        rhs = rs.make_rainshaft_rhs(config, data)
        step_fn = ensemble_rainshaft_step(rhs, config.dt, mesh)
        sharding = NamedSharding(mesh, P("columns"))

        def to_aos(y):
            return y

        def profile(y):
            return y.mean(axis=0)

    state = ensemble_state(pod_initial_condition(config), n_cols, step, sharding)

    @functools.partial(jax.jit, static_argnames=("n",))
    def chain(y, n):
        # all n steps inside ONE executable: the host dispatches once
        return jax.lax.fori_loop(0, n, lambda _, yy: step_fn(yy), y)

    n_steps = int(round(config.t_end / config.dt))
    # compiled outside the timed run: `run` pays only the device work
    run_exec = (
        jax.jit(lambda y: to_aos(chain(y, n_steps))).lower(state).compile()
    )
    # pod-scale observability: the scan emits the ensemble column-MEAN
    # moment profile [nz, n_tot] per save interval instead of the full
    # [n_cols, nz, n_tot] state; the mean over the sharded column axis is
    # the only collective of the run
    save_every = max(n_steps // 12, 1)
    n_saves = n_steps // save_every

    @functools.partial(jax.jit, static_argnames=("n_saves", "seg"))
    def chain_diag(y, n_saves, seg):
        def body(yy, _):
            yy = jax.lax.fori_loop(0, seg, lambda _, s: step_fn(s), yy)
            return yy, profile(yy)
        return jax.lax.scan(body, y, None, length=n_saves)

    def run():
        return jnp.arange(n_steps + 1.0), run_exec(state)[None]

    def run_diagnostics():
        """Mean-profile time series [n_saves, nz, n_tot] (separate pass —
        kept out of `run` so the recorded wall time stays the bare
        production rate)."""
        _, profs = chain_diag(state, n_saves, save_every)
        ts = config.dt * save_every * jnp.arange(1.0, n_saves + 1.0)
        return np.asarray(ts), np.asarray(profs)

    def run_checkpointed(ckpt_path, segment=None, max_segments=None):
        """The pod chain at SEGMENT granularity with a checkpoint written
        after every segment (a pod job that dies at step 100 of 1000 must
        not restart from zero). Resumes from the newest checkpoint under
        `ckpt_path` automatically; `max_segments` stops after that many
        segments (simulated preemption — returns None). The segment chain
        applies the same jitted `step_fn` the uninterrupted `run()` chain
        applies, in the same order, so a resumed run is BIT-IDENTICAL to an
        uninterrupted one (tests/test_harness.py pins this). npz
        checkpoints: exact f32 round-trip, no serializer in the loop."""
        from cloudy_tpu.utils import checkpoint as ck

        seg = int(segment or save_every)
        y, start = state, 0
        s0 = ck.latest_step(ckpt_path)
        if s0 is not None:
            y, start = ck.load_checkpoint(ckpt_path, s0, like=state)
            y = jax.device_put(jnp.asarray(y, state.dtype), sharding)
        done, nseg = start, 0
        while done < n_steps:
            k = min(seg, n_steps - done)
            y = jax.block_until_ready(chain(y, k))
            done += k
            ck.save_checkpoint(ckpt_path, jax.device_get(y), done)
            nseg += 1
            if max_segments is not None and nseg >= max_segments:
                return None
        return jnp.arange(n_steps + 1.0), to_aos(y)[None]

    return {
        "spec": spec,
        "config": config,
        "run": run,
        "run_checkpointed": run_checkpointed,
        "kind": "ensemble",
        "diagnostics": run_diagnostics,
    }


SCENARIOS: Dict[str, Callable] = {
    "box_single_gamma_golovin": _scenario_box_single_gamma,
    "box_exp_gamma_mixture": _scenario_box_exp_gamma_mixture,
    "box_long_numerical": _scenario_box_long_numerical,
    "rainshaft_128": _scenario_rainshaft_128,
    "pod_ensemble": _scenario_pod_ensemble,
    "pod_ensemble_moving": functools.partial(
        _scenario_pod_ensemble, variant="moving"
    ),
    "pod_ensemble_lognorm": functools.partial(
        _scenario_pod_ensemble, variant="lognorm"
    ),
}


def run_scenario(
    name: str,
    outdir: Optional[str] = None,
    ckpt_dir: Optional[str] = None,
    **scenario_kw,
):
    """Build, run, log and write outputs for one named scenario
    (`scenario_kw` go to its factory, e.g. ``n_columns``/``interpret`` for
    the pod ensembles). With `ckpt_dir`, scenarios that support it (the pod
    ensembles) run at segment granularity with a checkpoint per segment and
    resume from the newest checkpoint automatically."""
    sc = SCENARIOS[name](**scenario_kw)
    timer = metrics.StepTimer()
    t0 = time.perf_counter()
    if ckpt_dir and "run_checkpointed" in sc:
        os.makedirs(ckpt_dir, exist_ok=True)
        ts, ys = sc["run_checkpointed"](os.path.join(ckpt_dir, name))
    else:
        ts, ys = sc["run"]()
    jax.block_until_ready(ys)
    wall = time.perf_counter() - t0

    dev = jax.devices()[0]
    report = {
        "scenario": name,
        "wall_s": wall,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "n_devices": jax.device_count(),
    }
    if sc["kind"] == "ensemble":
        # pod-scale state: keep the reduction on the device (the full
        # [n_cols, nz, n_tot] ensemble is GBs)
        report["finite"] = bool(jnp.all(jnp.isfinite(ys[-1])))
        report.update(metrics.conservation_report(sc["spec"], ys[-1]))
        report["n_columns"] = int(np.prod(ys[-1].shape[:-2]))
        cfg = sc["config"]
        n_steps = int(round(cfg.t_end / cfg.dt))
        report["n_steps"] = n_steps
        report["column_updates_per_s"] = report["n_columns"] * n_steps / wall
        ts_np, ys_np = np.asarray(ts), None
    else:
        ts_np, ys_np = np.asarray(ts), np.asarray(ys)
        report["finite"] = bool(np.all(np.isfinite(ys_np)))
        report.update(
            metrics.conservation_report(sc["spec"], jnp.asarray(ys_np[-1]))
        )
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        if sc["kind"] == "ensemble" and "diagnostics" in sc:
            # ensemble observability: mean column profiles over time as a
            # rainshaft NetCDF (the full state is GBs; the mean is the
            # per-level ensemble diagnostic a pod job actually monitors)
            dts, dprofs = sc["diagnostics"]()
            io.rainshaft_output(
                os.path.join(outdir, f"{name}_mean_profile.nc"), sc["spec"],
                dts, sc["config"].z, dprofs, sc["config"].norms,
            )
        if sc["kind"] == "box":
            io.box_output(
                os.path.join(outdir, f"{name}.nc"), sc["spec"], ts_np, ys_np,
                sc["config"].norms,
            )
        elif sc["kind"] == "rainshaft":
            io.rainshaft_output(
                os.path.join(outdir, f"{name}.nc"), sc["spec"], ts_np,
                sc["config"].z, ys_np, sc["config"].norms,
            )
        metrics.JsonlLogger(os.path.join(outdir, "runs.jsonl")).log(report)
    return ts_np, ys_np, report


if __name__ == "__main__":
    import sys

    from cloudy_tpu.utils.cache import enable_compile_cache

    argv = sys.argv[1:]
    opts = {}
    for flag in ("--ckpt", "--columns"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
    kw = {}
    if "--interpret" in argv:  # the pod kernel in the Pallas interpreter
        argv.remove("--interpret")
        kw["interpret"] = True
    else:
        enable_compile_cache()
    if "--columns" in opts:
        kw["n_columns"] = int(opts["--columns"])
    names = argv or ["box_single_gamma_golovin"]
    for n in names:
        _, _, rep = run_scenario(
            n, outdir="scenario_output", ckpt_dir=opts.get("--ckpt"), **kw
        )
        print(rep)
