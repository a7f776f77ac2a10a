"""Benchmark: coalescence moment-updates/s on one GPU.

Runs the flagship analytical-coalescence RHS (closure inversion + exact-F2
incomplete-gamma autoconversion + Q/R/S bilinear form) over a large batch of
independent columns and reports throughput as moment-updates/s (columns/s
x prognostic moments per column).

``BENCH_IMPL``: "fused" (default) — the fused body as one Pallas kernel
through Triton (`ops.triton_coalescence.make_triton_coal_fn`); "xla" — the
einsum path (`coalescence.get_coal_ints`). ``BENCH_COLUMNS`` sets the batch (default
1,048,576).

`vs_baseline` contextualizes against the reference's single-CPU-core budget:
Cloudy.jl publishes no throughput numbers (BASELINE.md); its CI enforces
~27 us per `moment_source_helper` call (performance_tests.jl:83-89) and the
exp+gamma `get_coal_ints` performs 6 such integrals plus the Q/R/S sums
=> ~170 us/column => ~2.9e4 moment-updates/s on one CPU core. That figure is
the denominator.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "platform",
"device_kind", "device_count", "impl", "columns"}. Exits non-zero without a
GPU.
"""

import json
import os
import time

import numpy as np

REFERENCE_MOMENT_UPDATES_PER_S = 2.94e4  # see module docstring

# The fast-path configuration benched. Accuracy at THIS configuration is
# gated by tests/test_golden.py::test_pallas_gauss_trajectory_allclose[bench]
# (trajectory error vs the stored f64 reference-parity trajectory) and by a
# proven worst-case bound: the incomplete gamma is evaluated by the fixed
# Gauss-Legendre scheme (special.gammainc_gl, BENCH_GL_NODES nodes) whose max
# absolute error over the entire reachable (a, x) domain is pinned against
# scipy in tests/test_special.py. BENCH_F2_EXACT selects the exact
# autoconversion factorization F2(p,q) = M_p·M_q·P(2k+p+q, T/θ)
# (coalescence._msh_matrix_gamma_exact): one row-shaped incomplete gamma per
# column instead of a quadrature grid of them. BENCH_GAUSS_NODES only applies
# with BENCH_F2_EXACT=0 (the quadrature fallback).
BENCH_F2_EXACT = True
BENCH_GAUSS_NODES = 12
BENCH_GAMMAINC_ITERS = 12
BENCH_GL_NODES = 12
#: Euler-relaxation steps per timed chain, and timed repetitions (median)
CHAIN_STEPS = 20
REPS = 7


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: no GPU (JAX platform {dev.platform!r})")
    from cloudy_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from cloudy_tpu.spec import Family, SpectrumSpec
    from cloudy_tpu import kernels as K
    from cloudy_tpu import distributions as pdists
    from cloudy_tpu.coalescence import build_coalescence_data, get_coal_ints

    dtype = jnp.float32
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    f2_exact = bool(int(os.environ.get("BENCH_F2_EXACT", int(BENCH_F2_EXACT))))
    gl_nodes = int(os.environ.get("BENCH_GL_NODES", BENCH_GL_NODES))
    data = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=norms, gammainc_iters=12,
        f2_exact=f2_exact, gammainc_gl_nodes=gl_nodes,
    )

    impl = os.environ.get("BENCH_IMPL", "fused")
    B = int(os.environ.get("BENCH_COLUMNS", 1 << 20))
    rng = np.random.default_rng(0)
    mom_norms = np.concatenate([1e6 * 1e-9 ** np.arange(3)] * 2)
    base = np.array([1e8, 1e-2, 2e-12, 1.0, 1e-8, 2e-16]) / mom_norms
    # physically consistent per-column variation: joint amplitude and mass
    # scalings per mode (independent per-moment noise creates degenerate
    # states whose k-clip amplifies into f32 overflow)
    amp = np.repeat(rng.uniform(0.5, 2.0, (B, 2)), 3, axis=1)
    msc = np.repeat(rng.uniform(0.8, 1.25, (B, 2)), 3, axis=1) ** np.tile(
        np.arange(3.0), 2
    )
    mom = jnp.asarray(base[None, :] * amp * msc, dtype)

    if impl == "fused":
        from cloudy_tpu.ops import triton_coalescence as tc

        fn = tc.make_triton_coal_fn(
            data,
            quad_rule="gauss",
            gauss_nodes=int(os.environ.get("BENCH_GAUSS_NODES", BENCH_GAUSS_NODES)),
            gammainc_iters=int(
                os.environ.get("BENCH_GAMMAINC_ITERS", BENCH_GAMMAINC_ITERS)
            ),
        )
        mom = mom.T  # moment-major layout [n_tot, B]

        def rhs_step(mm):
            return mm + 1e-9 * fn.soa(mm)

    elif impl == "xla":

        def rhs_step(mm):
            dm = get_coal_ints(data, pdists.params_from_moments(spec, mm))
            return mm + 1e-9 * dm

    else:
        raise SystemExit(f"BENCH_IMPL={impl!r}: expected 'fused' or 'xla'")

    # CHAIN_STEPS sequential RHS evaluations with a data dependency between
    # them (an Euler relaxation), so no evaluation can be elided or
    # overlapped; one executable, one dispatch per timed run
    chain = jax.jit(
        lambda m: jax.lax.fori_loop(0, CHAIN_STEPS, lambda _, mm: rhs_step(mm), m)
    )
    jax.block_until_ready(chain(mom))  # compile + warm
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(mom))
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts)) / CHAIN_STEPS

    updates_per_s = B * spec.n_tot / dt
    print(
        json.dumps(
            {
                "metric": "coalescence_moment_updates_per_s_per_chip",
                "value": float(updates_per_s),
                "unit": "moment-updates/s",
                "vs_baseline": float(updates_per_s / REFERENCE_MOMENT_UPDATES_PER_S),
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": jax.device_count(),
                "impl": impl,
                "columns": B,
            }
        )
    )


if __name__ == "__main__":
    main()
