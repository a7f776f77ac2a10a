"""Chip smoke test: the pod rainshaft deployment end to end on one GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the sharded pod phase only

Phases (one process; any failure exits non-zero):

1. device — the card's name and power limit (nvidia-smi), the JAX version
   and JAX's device; anything but a GPU stops the run here.
2. compile — the production step compiled at full width (1,048,576 columns
   × 32 levels, f32), with its memory analysis.
3. parity — every pod variant at 65,536 columns: the f32 production step
   against the f64 AoS reference step (`make_rainshaft_rhs` + SSPRK33) on
   the card, row-scaled max error after 1 and after 120 steps, within
   `PARITY_BOUNDS`; and the f32 graph stays f32 with x64 on.
4. main path — `harness.run_scenario` for the three pod scenarios at full
   size: finite, no negative moments.

``--four`` runs `pod_ensemble` at 4 × 1,048,576 columns sharded over four
cards and compares it, and its mean-profile diagnostics, with a one-card
run of the first shard's columns.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

FULL_COLUMNS = 1 << 20
PARITY_COLUMNS = 1 << 16
VARIANTS = ("fixed2gamma", "moving", "lognorm")
#: row-scaled max |f32 − f64| bounds: (after 1 step, after 120 steps). 120
#: steps: the f32 trajectory gate of tests/test_golden.py. 1 step: f32
#: rounding of one step; lognorm: its window-quadrature bound of 4e-4
#: (coalescence._msh_matrix_lognormal_window) in f32 arithmetic.
PARITY_BOUNDS = {
    "fixed2gamma": (1e-4, 1e-3),
    "moving": (1e-4, 1e-3),
    "lognorm": (1e-3, 1e-3),
}


def require_gpu(devices):
    """Refuse anything but a GPU device list (never continue on the CPU)."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (JAX platform {platform!r}); refusing to run"
        )
    return devices


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)


def row_error(got, want):
    """max over rows of max |got − want| / max |want|; rows are moments
    (axis 0 of the level-major state)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    axes = tuple(range(1, want.ndim))
    scale = np.maximum(np.abs(want).max(axis=axes, keepdims=True), 1e-300)
    return float((np.abs(got - want) / scale).max())


def compile_phase():
    from cloudy_tpu import harness
    from cloudy_tpu.ops import triton_coalescence as tc

    t0 = phase("compile: production step at 1,048,576 x 32, f32")
    spec, data = harness.pod_data("fixed2gamma")
    cfg = harness.pod_config(spec)
    step = tc.make_triton_rainshaft_step_fn(
        data, cfg.vel, cfg.norms, nz=cfg.nz, dz=cfg.dz, dt=cfg.dt
    )
    y = jax.ShapeDtypeStruct((spec.n_tot, cfg.nz, FULL_COLUMNS), jnp.float32)
    compiled = step.lower(y).compile()
    print("   memory_analysis:", compiled.memory_analysis(), flush=True)
    done(t0)


def parity_phase():
    from cloudy_tpu import harness, stepper
    from cloudy_tpu.models import rainshaft as rs
    from cloudy_tpu.ops import triton_coalescence as tc

    n_steps = 120
    cases = {}
    for v in VARIANTS:
        t0 = phase(f"parity {v}: f32 production step, {PARITY_COLUMNS} columns")
        spec, data = harness.pod_data(v)
        cfg = harness.pod_config(spec)
        ic = harness.pod_initial_condition(cfg, second_mode=True)
        step = tc.make_triton_rainshaft_step_fn(
            data, cfg.vel, cfg.norms, nz=cfg.nz, dz=cfg.dz, dt=cfg.dt
        )
        chain = jax.jit(lambda y: jax.lax.fori_loop(0, n_steps, lambda _, u: step(u), y))
        y0 = harness.ensemble_state(ic, PARITY_COLUMNS, "fused", spread=(0.5, 1.5))
        got1 = np.asarray(step(y0))
        got_n = np.asarray(chain(y0))
        cases[v] = (spec, data, cfg, ic, step, y0, got1, got_n)
        done(t0)

    jax.config.update("jax_enable_x64", True)
    try:
        for v, (spec, data, cfg, ic, step, y0, got1, got_n) in cases.items():
            t0 = phase(f"parity {v}: f64 AoS reference step on the card")
            # weakly typed Python-scalar constants show as f64[] and fold
            # into f32; an f64 array would be a promoted f32 graph
            jaxpr = str(jax.make_jaxpr(step)(y0))
            if re.search(r"f64\[\d", jaxpr) or step(y0).dtype != jnp.float32:
                raise AssertionError(f"{v}: the f32 step computes in f64 with x64 on")
            rhs = rs.make_rainshaft_rhs(cfg, data)
            t = jnp.asarray(0.0, jnp.float64)

            def ref_step(y):
                return stepper.ssprk33_step(rhs, y, t, cfg.dt)

            ref_chain = jax.jit(
                lambda y: jax.lax.fori_loop(0, n_steps, lambda _, u: ref_step(u), y)
            )
            y64 = harness.ensemble_state(
                ic, PARITY_COLUMNS, "reference", spread=(0.5, 1.5), dtype=jnp.float64
            )
            want1 = rs.to_soa(jax.jit(ref_step)(y64))
            want_n = rs.to_soa(ref_chain(y64))
            e1, en = row_error(got1, want1), row_error(got_n, want_n)
            b1, bn = PARITY_BOUNDS[v]
            print(
                f"   {v}: row-scaled max error 1 step {e1:.3e} (bound {b1:.0e}), "
                f"{n_steps} steps {en:.3e} (bound {bn:.0e})",
                flush=True,
            )
            if not (e1 < b1 and en < bn):
                raise AssertionError(f"{v}: parity outside its bounds")
            done(t0)
    finally:
        jax.config.update("jax_enable_x64", False)


def check_report(rep):
    print("  ", rep, flush=True)
    if not (rep["finite"] and rep["negative_fraction"] == 0.0):
        raise AssertionError(f"{rep['scenario']}: unhealthy state")


def main_path_phase():
    from cloudy_tpu import harness

    for name in ("pod_ensemble", "pod_ensemble_moving", "pod_ensemble_lognorm"):
        t0 = phase(f"main path: harness.run_scenario({name!r})")
        _, _, rep = harness.run_scenario(name)
        check_report(rep)
        done(t0)


def four_card_phase():
    from cloudy_tpu import harness

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devices)}")
    t0 = phase("four cards: pod_ensemble at 4 x 1,048,576 columns")
    sc4 = harness._scenario_pod_ensemble(4 * FULL_COLUMNS, devices=devices[:4])
    t1 = time.perf_counter()
    _, ys4 = sc4["run"]()
    ys4 = jax.block_until_ready(ys4)
    print(f"   4-card run {time.perf_counter() - t1:.3f} s", flush=True)
    first4 = np.asarray(ys4[-1, :FULL_COLUMNS])
    finite = bool(np.isfinite(first4).all())
    _, prof4 = sc4["diagnostics"]()
    del sc4, ys4
    done(t0)

    t0 = phase("one card: the first shard's 1,048,576 columns")
    sc1 = harness._scenario_pod_ensemble(FULL_COLUMNS, devices=devices[:1])
    t1 = time.perf_counter()
    _, ys1 = sc1["run"]()
    first1 = np.asarray(jax.block_until_ready(ys1)[-1])
    print(f"   1-card run {time.perf_counter() - t1:.3f} s", flush=True)
    _, prof1 = sc1["diagnostics"]()
    done(t0)

    identical = bool(np.array_equal(first4, first1))
    prof_err = row_error(np.moveaxis(prof4, -1, 0), np.moveaxis(prof1, -1, 0))
    print(
        f"   first shard bit-identical to one card: {identical}; finite: "
        f"{finite}; mean-profile diagnostics row-scaled max diff {prof_err:.3e}",
        flush=True,
    )
    if not (identical and finite and prof_err < 1e-5):
        raise AssertionError("four-card run differs from the one-card run")


def main(argv):
    four = "--four" in argv
    devices = jax.devices()
    t0 = phase("device")
    require_gpu(devices)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    dev = devices[0]
    print(
        f"   jax {jax.__version__}; platform {dev.platform}; device_kind "
        f"{dev.device_kind}; count {len(devices)}",
        flush=True,
    )
    from cloudy_tpu.utils.cache import enable_compile_cache

    print("   compile cache:", enable_compile_cache(), flush=True)
    done(t0)

    if four:
        four_card_phase()
        count = 4
    else:
        compile_phase()
        parity_phase()
        main_path_phase()
        count = 1
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": count},
    }))


if __name__ == "__main__":
    main(sys.argv[1:])
