"""Performance-structure guards — the JAX analogue of the reference's JET
type-stability and allocation CI gates (SURVEY.md §4/§6):

- a step must not retrace across same-shape calls,
- the coalescence RHS must compile loop-free (no `while` in optimized HLO;
  a regression to rolled special-function loops costs ~10x in HBM traffic),
- the scanned integrator must compile to a single program containing one
  loop (the time scan itself).
"""

import numpy as np
import jax
import jax.numpy as jnp

from cloudy_tpu.spec import Family, SpectrumSpec
from cloudy_tpu import kernels as K
from cloudy_tpu import distributions as pd
from cloudy_tpu.coalescence import build_coalescence_data, get_coal_ints
from cloudy_tpu.utils import debug


def _rhs_setup():
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9), gammainc_iters=32
    )
    rhs = lambda m: get_coal_ints(data, pd.params_from_moments(spec, m))
    mom = jnp.asarray(
        np.abs(np.random.default_rng(0).normal(1, 0.1, (32, 6)))
        * np.array([1e2, 1e1, 2.0, 1e-6, 1e-5, 2e-4])
    )
    return rhs, mom


def test_rhs_no_retrace():
    rhs, mom = _rhs_setup()
    debug.assert_no_retrace(rhs, [(mom,), (mom * 1.5,), (mom * 0.5,)])


def test_rhs_compiles_loop_free():
    """The unrolled incomplete-gamma evaluation must stay unrolled: a rolled
    `while` materializes [B, G] carries in HBM every iteration (measured 8x
    step-time regression)."""
    rhs, mom = _rhs_setup()
    assert debug.count_hlo_ops(rhs, mom, opname="while") == 0


def test_integrate_single_scan():
    from cloudy_tpu import stepper

    f = lambda y, t: -y
    y0 = jnp.ones(4)

    def run(y):
        _, ys = stepper.integrate(f, y, 0.0, 0.1, 10, save_every=5)
        return ys

    txt = debug.hlo_text(run, y0)
    # outer scan over saved chunks + inner scan over substeps = at most 2
    assert txt.count(" while(") <= 2


def test_step_output_count():
    """The jitted RHS should return exactly one array (no accidental
    auxiliary outputs forcing extra HBM writes)."""
    rhs, mom = _rhs_setup()
    out = jax.jit(rhs)(mom)
    assert out.shape == mom.shape


# ---------------------------------------------------------------------------
# wall-clock budgets — the reference's performance_tests.jl analogue
# Budgets are ~4x the measured value on the 2-core sandbox
# so they only trip on order-of-magnitude regressions (a rolled special-
# function loop, an accidental retrace, a slow fallback in a
# production path), not on CI machine variance.
# ---------------------------------------------------------------------------

import time


def _median_time(fn, reps=5):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def test_budget_build_coalescence_data():
    """Init-time precompute (reference CoalescenceData ≤400 B/≤µs-scale,
    test_Sources_opt.jl:38-40). Measured ~1.3 ms; budget 1 s."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    t = _median_time(
        lambda: build_coalescence_data(
            spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9)
        ),
        reps=3,
    )
    assert t < 1.0, f"build_coalescence_data took {t:.3f}s (budget 1s)"


def test_budget_xla_coal_rhs():
    """One jitted XLA coalescence RHS step at B = 1024 on CPU (reference
    `get_coal_ints` <~170 µs/column single-core; performance_tests.jl:83-89).
    Measured ~76 ms warm; budget 0.4 s."""
    rhs, mom = _rhs_setup()
    mom1024 = jnp.tile(mom, (32, 1))
    jrhs = jax.jit(rhs)
    jrhs(mom1024).block_until_ready()  # compile
    t = _median_time(lambda: jrhs(mom1024).block_until_ready())
    assert t < 0.4, f"XLA coal RHS (B=1024) took {t:.3f}s (budget 0.4s)"


def test_budget_interpret_pallas_block():
    """One RHS-only Triton kernel call in the Pallas interpreter at
    B = 128, compile included (measured ~3.5-3.9 s). Budget 16 s: catches
    an accidental 10x blowup of the kernel's unrolled body."""
    from cloudy_tpu.ops import triton_coalescence as tc

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9), gammainc_iters=32
    )
    fn = tc.make_triton_coal_fn(data, block_cols=128, interpret=True)
    mom = jnp.asarray(
        np.abs(np.random.default_rng(0).normal(1, 0.1, (128, 6)))
        * np.array([1e2, 1e1, 2.0, 1e-6, 1e-5, 2e-4])
    )
    t0 = time.perf_counter()
    np.asarray(fn(mom))
    t = time.perf_counter() - t0
    assert t < 16.0, f"interpreted kernel block took {t:.1f}s (budget 16s)"


def test_budget_golden_fast_tier():
    """The default golden tier's most expensive live case (the Golovin box
    scenario, compile + 120 integration steps). Measured ~7 s cold; budget
    45 s — CI fails on a 6x regression of the end-to-end fast tier."""
    from cloudy_tpu import harness

    t0 = time.perf_counter()
    ts, ys = harness.SCENARIOS["box_single_gamma_golovin"]()["run"]()
    np.asarray(ys)
    t = time.perf_counter() - t0
    assert t < 45.0, f"golden fast-tier scenario took {t:.1f}s (budget 45s)"


def test_fast_tier_rhs_compiles_loop_free():
    """The round-4 fast-tier paths (exact-F2 + GL incomplete gamma, the
    lognormal window rule, the Halley/GL moving-threshold inverse,
    gamma_ratio) must also lower loop-free — everything is unrolled
    straight-line code by construction."""
    for fams, thr, moving, lnw in [
        ((Family.GAMMA, Family.GAMMA), (0.9, 1.0), True, 0),
        ((Family.LOGNORMAL, Family.GAMMA), (5e-10, np.inf), False, 16),
    ]:
        spec = SpectrumSpec(fams)
        ker = K.CoalescenceTensor.from_function(
            K.LinearKernelFunction(5.0), 1, 1e-6
        )
        data = build_coalescence_data(
            spec, ker, thr, norms=(1e6, 1e-9), moving=moving,
            gammainc_iters=12, f2_exact=True, gammainc_gl_nodes=12,
            lognorm_gl_nodes=lnw,
        )
        rhs = lambda m: get_coal_ints(data, pd.params_from_moments(spec, m))
        mom = jnp.asarray(
            np.abs(np.random.default_rng(1).normal(1, 0.1, (16, 6)))
            * np.array([1e2, 1e1, 2.0, 1e-1, 1e-2, 2e-2])
        )
        assert debug.count_hlo_ops(rhs, mom, opname="while") == 0, fams
