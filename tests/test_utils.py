"""IO / checkpoint / metrics / debug utilities."""


import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cloudy_tpu.spec import Family, SpectrumSpec
from cloudy_tpu.utils import io, metrics, checkpoint, debug


SPEC = SpectrumSpec((Family.GAMMA, Family.EXPONENTIAL))


def _traj(n_t=4):
    rng = np.random.default_rng(0)
    ts = np.linspace(0, 30, n_t)
    ys = np.abs(rng.normal(1, 0.1, (n_t, SPEC.n_tot))) * np.array(
        [1e8, 1e-2, 2e-12, 1.0, 1e-8]
    )
    return ts, ys


def test_netcdf_box_roundtrip(tmp_path):
    ts, ys = _traj()
    path = str(tmp_path / "box.nc")
    io.box_output(path, SPEC, ts, ys)
    from scipy.io import netcdf_file

    with netcdf_file(path, "r") as f:
        assert f.variables["time"].shape == (4,)
        assert f.variables["moments"].shape == (4, 2, 3)
        mom = np.asarray(f.variables["moments"][:])
        np.testing.assert_allclose(mom[:, 0, :], ys[:, :3], rtol=1e-12)
        # exp mode padded with zero in order-2 slot
        np.testing.assert_allclose(mom[:, 1, :2], ys[:, 3:], rtol=1e-12)
        for name in ["N_liq", "N_rai", "M_liq", "M_rai", "params", "moments_sum"]:
            assert name in f.variables


def test_netcdf_rainshaft(tmp_path):
    ts, _ = _traj()
    nz = 5
    rng = np.random.default_rng(1)
    ys = np.abs(rng.normal(1, 0.1, (4, nz, SPEC.n_tot))) * np.array(
        [1e8, 1e-2, 2e-12, 1.0, 1e-8]
    )
    z = np.linspace(0, 3000, nz)
    path = str(tmp_path / "shaft.nc")
    io.rainshaft_output(path, SPEC, ts, z, ys)
    from scipy.io import netcdf_file

    with netcdf_file(path, "r") as f:
        assert f.variables["moments"].shape == (4, nz, 2, 3)


def test_npz_roundtrip(tmp_path):
    ts, ys = _traj()
    path = str(tmp_path / "traj.npz")
    io.save_npz(path, ts=ts, ys=ys)
    data = io.load_npz(path)
    np.testing.assert_array_equal(data["ys"], ys)


def test_checkpoint_roundtrip_npz(tmp_path):
    state = {"mom": jnp.ones((3, 4)), "t": jnp.asarray(1.5)}
    path = str(tmp_path / "ck")
    checkpoint.save_checkpoint(path, state, step=7)
    got, step = checkpoint.load_checkpoint(path, 7, like=state)
    assert step == 7
    np.testing.assert_array_equal(np.asarray(got["mom"]), np.ones((3, 4)))
    assert checkpoint.latest_step(path) == 7


def test_run_segments_resume(tmp_path):
    step_fn = lambda y: y * 2.0
    path = str(tmp_path / "seg")
    out, done = checkpoint.run_segments(
        step_fn, jnp.asarray([1.0]), n_steps=4, segment=2, ckpt_path=path
    )
    assert done == 4
    assert float(out[0]) == 16.0
    # resume: pretend restart after the first segment
    out2, done2 = checkpoint.run_segments(
        step_fn, jnp.asarray([1.0]), n_steps=6, segment=2, ckpt_path=path
    )
    assert done2 == 6
    assert float(out2[0]) == 64.0  # resumed from step-4 state (16) x 2 x 2


def test_conservation_report():
    ts, ys = _traj()
    rep = metrics.conservation_report(SPEC, jnp.asarray(ys[0]))
    assert rep["total_mass"] > 0
    assert rep["negative_fraction"] == 0.0
    assert rep["nonfinite_fraction"] == 0.0


def test_step_timer():
    t = metrics.StepTimer()
    f = jax.jit(lambda x: x * 2)
    for _ in range(3):
        t.timed_call(f, jnp.ones(8))
    s = t.summary()
    assert s["n"] == 3 and s["mean_s"] > 0


def test_assert_no_retrace():
    calls = []

    def f(x):
        return x + 1

    debug.assert_no_retrace(f, [(jnp.ones(3),), (jnp.ones(3) * 2,)])
    with pytest.raises(AssertionError):
        debug.assert_no_retrace(f, [(jnp.ones(3),), (jnp.ones(4),)])


def test_hlo_probe():
    n = debug.count_hlo_ops(lambda x: x * 2 + 1, jnp.ones(4), opname="while")
    assert n == 0


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """The command-line entry points keep JAX's compile cache where
    JAX_COMPILATION_CACHE_DIR says, else at one fixed git-ignored path in
    the checkout."""
    import os

    from cloudy_tpu.utils import cache

    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.compile_cache_dir() == str(tmp_path)
        return
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.compile_cache_dir()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == cache.DEFAULT_DIR
    assert os.path.dirname(path) == repo
    with open(os.path.join(repo, ".gitignore")) as f:
        assert os.path.basename(path) + "/" in f.read().split()
