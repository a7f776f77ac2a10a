"""Shared example harness: build → integrate → plot → NetCDF.

Mirrors the role of the reference's test/examples/utils helpers. Each example
script defines a scenario and calls `run_box_example` / `run_rainshaft_example`.
Outputs land in examples/output/.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from cloudy_tpu.spec import Family, SpectrumSpec  # noqa: F401 (re-export)
from cloudy_tpu import kernels as K  # noqa: F401
from cloudy_tpu import distributions as pdists  # noqa: F401 (re-export)
from cloudy_tpu.coalescence import build_coalescence_data
from cloudy_tpu.models import box, rainshaft as rs
from cloudy_tpu.utils import io, plotting

OUTDIR = os.environ.get(
    "CLOUDY_TPU_OUTDIR", os.path.join(os.path.dirname(__file__), "output")
)
NORMS = (1e6, 1e-9)

# CI fast tier (tests/test_examples.py runs EVERY example, mirroring the
# reference's per-example Buildkite jobs): CLOUDY_EXAMPLE_FAST=1 shrinks the
# integration horizon / column height so the full set stays under ~3 min,
# while each script still exercises its complete build → integrate → plot →
# NetCDF pipeline at its real physics configuration.
FAST = bool(int(os.environ.get("CLOUDY_EXAMPLE_FAST", "0")))


def _fast_time(t_end, dt, n_steps_fast=4):
    return (min(t_end, n_steps_fast * dt), dt) if FAST else (t_end, dt)


def _ensure_outdir():
    os.makedirs(OUTDIR, exist_ok=True)
    return OUTDIR


def run_box_example(
    name,
    spec,
    moments_init,
    kernel=None,
    kernel_func=None,
    thresholds=None,
    moving=False,
    t_end=120.0,
    dt=10.0,
    numerical=False,
    norms=NORMS,
    logxrange=(-12, -3),
):
    """Analytical (kernel tensor) or numerical (kernel function) box run with
    the standard outputs (reference box_* examples)."""
    out = _ensure_outdir()
    if thresholds is None:
        thresholds = (np.inf,) * spec.n_modes
    t_end, dt = _fast_time(t_end, dt)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=t_end, dt=dt)
    if numerical:
        rhs = jax.jit(box.make_box_rhs(config, kernel_func=kernel_func, numerical=True))
    else:
        data = build_coalescence_data(spec, kernel, thresholds, norms=norms, moving=moving)
        rhs = jax.jit(box.make_box_rhs(config, coal_data=data))
    ts, ys = box.run_box(config, rhs, jnp.asarray(moments_init))
    ts, ys = np.asarray(ts), np.asarray(ys)

    plotting.plot_moments(spec, ts, ys, f"{out}/{name}_moments.png", norms)
    plotting.plot_params(spec, ts, ys, f"{out}/{name}_params.png", norms)
    plotting.plot_spectra(spec, ts, ys, f"{out}/{name}_spectra.png", norms, logxrange)
    io.box_output(f"{out}/{name}.nc", spec, ts, ys, norms)
    print(f"[{name}] final moments: {ys[-1]}")
    return ts, ys


def run_condensation_example(name, spec, moments_init, s=0.01, xi=1e-10,
                             t_end=10.0, dt=0.25, norms=NORMS):
    out = _ensure_outdir()
    t_end, dt = _fast_time(t_end, dt)
    config = box.BoxConfig(spec=spec, norms=norms, t_end=t_end, dt=dt)
    rhs = jax.jit(box.make_box_condensation_rhs(config, s=s, xi=xi))
    ts, ys = box.run_box(config, rhs, jnp.asarray(moments_init))
    ts, ys = np.asarray(ts), np.asarray(ys)
    plotting.plot_moments(spec, ts, ys, f"{out}/{name}_moments.png", norms)
    io.box_output(f"{out}/{name}.nc", spec, ts, ys, norms)
    print(f"[{name}] final moments: {ys[-1]}")
    return ts, ys


def run_rainshaft_example(
    name,
    spec,
    mom_amp,
    kernel=None,
    thresholds=None,
    nz=60,
    zmax=3000.0,
    # flagship-duration parity: the reference rainshaft examples integrate
    # to t = 1000 s (rainshaft_single_gamma.jl:30, rainshaft_gamma_mixture.jl:32)
    t_end=1000.0,
    dt=1.0,
    norms=NORMS,
):
    out = _ensure_outdir()
    if thresholds is None:
        thresholds = (np.inf,) * spec.n_modes
    t_end, dt = _fast_time(t_end, dt)
    if FAST:
        nz = min(nz, 16)
    config = rs.RainshaftConfig(
        spec=spec, nz=nz, zmax=zmax, norms=norms, t_end=t_end, dt=dt,
        save_every=max(1, int(t_end / dt) // 20),
    )
    data = (
        build_coalescence_data(spec, kernel, thresholds, norms=norms)
        if kernel is not None
        else None
    )
    rhs = jax.jit(rs.make_rainshaft_rhs(config, data))
    ic = rs.initial_condition(config.z, mom_amp[: spec.nprogmoms[0]])
    if spec.n_modes > 1:
        pad = np.zeros((config.nz, spec.n_tot - ic.shape[1]))
        ic = np.concatenate([ic, pad], axis=-1)
    ts, ys = rs.run_rainshaft(config, rhs, ic)
    ts, ys = np.asarray(ts), np.asarray(ys)
    plotting.plot_rainshaft_results(spec, ts, config.z, ys, f"{out}/{name}.png", norms)
    io.rainshaft_output(f"{out}/{name}.nc", spec, ts, config.z, ys, norms)
    print(f"[{name}] total mass t0={ys[0][..., 1].sum():.3e} tend={ys[-1][..., 1].sum():.3e}")
    return ts, config.z, ys
