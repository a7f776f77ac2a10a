"""Scenario harness smoke tests (the cheap scenarios)."""

import numpy as np
import pytest

from cloudy_tpu import harness


def test_box_single_gamma_scenario(tmp_path):
    ts, ys, rep = harness.run_scenario(
        "box_single_gamma_golovin", outdir=str(tmp_path)
    )
    assert rep["finite"]
    # golovin number decay anchor
    np.testing.assert_allclose(
        ys[-1, 0], 1e8 * np.exp(-5.0 * 1e-2 * ts[-1]), rtol=1e-3
    )
    assert (tmp_path / "box_single_gamma_golovin.nc").exists()
    assert (tmp_path / "runs.jsonl").exists()


def test_exp_gamma_mixture_scenario(tmp_path):
    ts, ys, rep = harness.run_scenario("box_exp_gamma_mixture", outdir=str(tmp_path))
    assert rep["finite"]
    # total mass conserved (flat mass indices via the spec, exp has 2 moments)
    from cloudy_tpu.spec import Family, SpectrumSpec

    spec = SpectrumSpec((Family.EXPONENTIAL, Family.GAMMA))
    i0, i1 = spec.dist_moment_ind(0, 1), spec.dist_moment_ind(1, 1)
    np.testing.assert_allclose(
        ys[-1, i0] + ys[-1, i1], ys[0, i0] + ys[0, i1], rtol=1e-6
    )


def test_scenario_registry_complete():
    assert set(harness.SCENARIOS) == {
        "box_single_gamma_golovin",
        "box_exp_gamma_mixture",
        "box_long_numerical",
        "rainshaft_128",
        "pod_ensemble",
        "pod_ensemble_moving",
        "pod_ensemble_lognorm",
    }


def test_pod_ensemble_scenario_smoke_with_diagnostics(tmp_path):
    """The pod scenario at toy scale on CPU (the production kernel in the
    Pallas interpreter): on-device fori_loop chain,
    conservation report, and the mean-profile diagnostics NetCDF (the
    pod-scale observability output — the full state is GBs on the real
    workload, the per-level ensemble mean is what a pod job monitors)."""
    sc = harness._scenario_pod_ensemble(n_columns=8, interpret=True)
    # run through run_scenario for the full output path
    import cloudy_tpu.harness as H

    orig = H.SCENARIOS["pod_ensemble"]
    H.SCENARIOS["pod_ensemble"] = lambda: sc
    try:
        ts, ys, rep = harness.run_scenario("pod_ensemble", outdir=str(tmp_path))
    finally:
        H.SCENARIOS["pod_ensemble"] = orig
    assert rep["finite"]
    assert rep["negative_fraction"] == 0.0
    assert rep["n_columns"] == 8
    nc = tmp_path / "pod_ensemble_mean_profile.nc"
    assert nc.exists()


@pytest.mark.parametrize("variant", ["moving", "lognorm"])
def test_pod_ensemble_variant_scenarios_smoke(variant):
    """The MovingThreshold and lognormal production variants
    get the same pod treatment as the flagship — toy-scale CPU smoke of the
    registered scenarios' chains + conservation."""
    import jax.numpy as jnp

    from cloudy_tpu.utils import metrics

    sc = harness._scenario_pod_ensemble(
        n_columns=8, variant=variant, interpret=True
    )
    ts, ys = sc["run"]()
    assert bool(jnp.all(jnp.isfinite(ys[-1])))
    rep = metrics.conservation_report(sc["spec"], ys[-1])
    assert rep["negative_fraction"] == 0.0


@pytest.mark.parametrize("variant", ["fixed2gamma", "moving"])
def test_pod_checkpoint_resume_bit_identical(tmp_path, variant):
    """The pod chain survives a restart at segment
    granularity — for the flagship AND a second production variant.
    Simulate preemption after 1 segment (run_checkpointed returns None),
    resume — the resumed run restarts from the checkpoint, not from zero,
    and the final state is BIT-IDENTICAL to an uninterrupted segmented
    run AND to the plain un-checkpointed chain."""
    import numpy as np

    sc = harness._scenario_pod_ensemble(
        n_columns=8, variant=variant, interpret=True
    )

    # uninterrupted checkpointed run (fresh dir)
    d1 = tmp_path / "full"
    d1.mkdir()
    ts_full, ys_full = sc["run_checkpointed"](str(d1 / "pod"), segment=40)

    # interrupted: die after one 40-step segment, then resume
    d2 = tmp_path / "interrupted"
    d2.mkdir()
    out = sc["run_checkpointed"](str(d2 / "pod"), segment=40, max_segments=1)
    assert out is None  # simulated preemption mid-job
    from cloudy_tpu.utils import checkpoint as ck

    assert ck.latest_step(str(d2 / "pod")) == 40  # durable progress exists
    ts_res, ys_res = sc["run_checkpointed"](str(d2 / "pod"), segment=40)

    np.testing.assert_array_equal(np.asarray(ys_res), np.asarray(ys_full))

    # the un-checkpointed production chain reaches the same state
    _, ys_plain = sc["run"]()
    np.testing.assert_array_equal(np.asarray(ys_full), np.asarray(ys_plain))
