"""Multi-process (multi-host analogue) bring-up tests.

BASELINE's north star is 1 chip → 1 host → N hosts scaling; the reference has
no distributed code at all, so this subsystem is BUILD-NEW and needs its own
test tier. A real 2-process jax.distributed cluster is exercised here on CPU:
two subprocesses, a local TCP coordinator, one CPU device each, and one
column-sharded ensemble step over the resulting 2-device global mesh — the
same `initialize_distributed` + `make_mesh` + `ensemble_rainshaft_step` call
sequence a multi-host launch uses (cloudy_tpu/parallel/mesh.py).

Also pins the failure policy: a detected cluster launch whose initialization
fails must RAISE, never degrade into N independent single-process runs.
"""

import os
import socket
import subprocess
import sys

import pytest

import cloudy_tpu.parallel.mesh as mesh_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys

port, pid = sys.argv[1], int(sys.argv[2])

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from cloudy_tpu.parallel.mesh import initialize_distributed, make_mesh

# must run BEFORE any backend/device query
is_multi = initialize_distributed(f"localhost:{port}", 2, pid)
assert is_multi, "expected a 2-process cluster"
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 2, jax.devices()

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cloudy_tpu.spec import Family, SpectrumSpec
from cloudy_tpu import kernels as K, stepper
from cloudy_tpu.coalescence import build_coalescence_data
from cloudy_tpu.models import rainshaft as rs
from cloudy_tpu.parallel.ensemble import ensemble_rainshaft_step

spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
norms = (1e6, 1e-9)
ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=norms,
                              gammainc_iters=16)
config = rs.RainshaftConfig(spec=spec, nz=8, zmax=3000.0, norms=norms,
                            t_end=1.0, dt=1.0)
rhs = rs.make_rainshaft_rhs(config, data)

n_cols = 8  # 4 per process
ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
# deterministic per-column variation over the GLOBAL column index
global_state = np.stack(
    [ic * (1.0 + 0.1 * c) for c in range(n_cols)], axis=0
)

mesh = make_mesh(("columns",))
sharding = NamedSharding(mesh, P("columns"))
local = global_state[pid * 4 : (pid + 1) * 4]
y = jax.make_array_from_process_local_data(sharding, local, global_state.shape)

step = jax.jit(
    ensemble_rainshaft_step(rhs, config.dt, mesh, with_diagnostics=True,
                            spec=spec)
)
y1, total_mass = step(y)

# the sharded step must agree with an unsharded single-device evaluation of
# this process's own columns (columns are independent — that is the design)
want = np.asarray(
    stepper.STEPPERS["ssprk33"](rhs, jnp.asarray(local), jnp.asarray(0.0), config.dt)
)
got = np.concatenate(
    [np.asarray(s.data) for s in sorted(y1.addressable_shards, key=lambda s: s.index)]
)
np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)

# the psum total is replicated: every process sees the global sum
want_total = None
print(f"OK pid={pid} total_mass={float(total_mass):.17e}", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n_procs", [2])
def test_two_process_cluster_column_sharded_step(tmp_path, n_procs):
    """Real jax.distributed bring-up: 2 CPU processes, local TCP coordinator,
    one sharded ensemble step, per-shard parity with unsharded evaluation,
    replicated psum diagnostics."""
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", str(script), str(port), str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=REPO,
        )
        for pid in range(n_procs)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"OK pid={pid}" in out, out
    # both processes report the same replicated global mass
    masses = {
        line.split("total_mass=")[1]
        for out in outs
        for line in out.splitlines()
        if "total_mass=" in line
    }
    assert len(masses) == 1, masses


def test_initialize_raises_when_cluster_env_present(monkeypatch):
    """A detected cluster launch whose init fails must raise, not silently
    fall back to single-process (parallel/mesh.py failure policy)."""
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "2")

    def boom(**kwargs):
        raise RuntimeError("coordination service unreachable")

    monkeypatch.setattr(mesh_mod.jax.distributed, "initialize", boom)
    assert mesh_mod.cluster_env_detected()
    with pytest.raises(RuntimeError, match="refusing to continue"):
        mesh_mod.initialize_distributed()


def test_initialize_noop_without_cluster(monkeypatch):
    """No cluster signals at all -> single-process, returns False, no raise."""
    for v in mesh_mod._CLUSTER_ENV_VARS:
        monkeypatch.delenv(v, raising=False)

    def boom(**kwargs):
        raise RuntimeError("could not autodetect a cluster")

    monkeypatch.setattr(mesh_mod.jax.distributed, "initialize", boom)
    assert not mesh_mod.cluster_env_detected()
    assert mesh_mod.initialize_distributed() is False


def test_initialize_already_initialized(monkeypatch):
    """Re-initialization reports the existing cluster state instead of
    raising (idempotent bring-up in notebooks / resumed runs)."""

    def already(**kwargs):
        raise RuntimeError("jax.distributed is already initialized")

    monkeypatch.setattr(mesh_mod.jax.distributed, "initialize", already)
    assert mesh_mod.initialize_distributed() is False  # 1 process in tests
