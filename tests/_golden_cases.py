"""Golden-trajectory cases: canonical runs whose full moment trajectories are
stored under tests/golden/*.npz and pinned by tests/test_golden.py.

This is the framework's equivalent of the reference's trajectory-level
validation (SURVEY.md §4: Smoluchowski-1916 anchor, Golovin Bessel solution,
allclose-vs-Cloudy.jl north star in BASELINE.md): the stored trajectories are
produced by the f64 CPU reference-parity path, cross-checked against the
independent C++ oracle (native/cloudy_golden.cc), and every fast path (f32,
Pallas, Gauss quadrature rule) must stay allclose to them.

Regenerate after an intentional physics change:

    JAX_PLATFORMS=cpu python tests/_golden_cases.py
"""

from __future__ import annotations

import os

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _case_rainshaft_small():
    """1-D rainshaft, 32 levels, coalescence + upwind sedimentation — a
    scaled-down BASELINE configs[3] sized for CI."""
    import jax
    import jax.numpy as jnp

    from cloudy_tpu.spec import Family, SpectrumSpec
    from cloudy_tpu import kernels as K
    from cloudy_tpu.coalescence import build_coalescence_data
    from cloudy_tpu.models import rainshaft as rs

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=norms)
    config = rs.RainshaftConfig(
        spec=spec, nz=32, zmax=3000.0, norms=norms, t_end=120.0, dt=1.0,
        save_every=20,
    )
    rhs = jax.jit(rs.make_rainshaft_rhs(config, data))
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    ts, ys = rs.run_rainshaft(config, rhs, ic)
    return np.asarray(ts), np.asarray(ys)


def _harness_case(name):
    def run():
        from cloudy_tpu import harness

        ts, ys = harness.SCENARIOS[name]()["run"]()
        return np.asarray(ts), np.asarray(ys)

    return run


def _case_rainshaft_128_thinned():
    """BASELINE configs[3] at full size (nz = 128, 300 s), thinned to every
    30th step — the flagship-scale scenario, golden-pinned end to end
    Identical construction to harness.rainshaft_128."""
    from cloudy_tpu import harness

    ts, ys = harness.SCENARIOS["rainshaft_128"]()["run"]()
    return np.asarray(ts), np.asarray(ys)


CASES = {
    "box_single_gamma_golovin": _harness_case("box_single_gamma_golovin"),
    "box_exp_gamma_mixture": _harness_case("box_exp_gamma_mixture"),
    "box_long_numerical": _harness_case("box_long_numerical"),
    "rainshaft_small": _case_rainshaft_small,
    "rainshaft_128": _case_rainshaft_128_thinned,
}


def golden_path(name: str) -> str:
    return os.path.join(GOLDEN_DIR, f"{name}.npz")


def load_golden(name: str):
    with np.load(golden_path(name)) as z:
        return z["ts"], z["ys"]


def generate(names=None):
    unknown = set(names or ()) - set(CASES)
    if unknown:
        raise SystemExit(
            f"unknown case(s) {sorted(unknown)}; choose from {sorted(CASES)}"
        )
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in names or CASES:
        ts, ys = CASES[name]()
        assert np.all(np.isfinite(ys)), name
        assert ts.dtype == np.float64 and ys.dtype == np.float64, (
            f"{name}: golden data must be generated on the f64 CPU path"
        )
        np.savez_compressed(golden_path(name), ts=ts, ys=ys)
        print(f"wrote {golden_path(name)}  ts{ts.shape} ys{ys.shape}")


if __name__ == "__main__":
    import sys

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    generate(sys.argv[1:] or None)
