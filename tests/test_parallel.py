"""Multi-device sharding tests on the 8-device virtual CPU mesh:
column-sharded ensembles, z-sharded halo exchange, determinism across
shardings — the distributed test tier the reference lacks entirely
(SURVEY.md §4 'Distributed testing: none exists')."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from cloudy_tpu.spec import Family, SpectrumSpec
from cloudy_tpu import kernels as K
from cloudy_tpu.coalescence import build_coalescence_data
from cloudy_tpu.models import rainshaft as rs
from cloudy_tpu.parallel.mesh import make_mesh
from cloudy_tpu.parallel.ensemble import ensemble_rainshaft_step
from cloudy_tpu.parallel.halo import (
    make_z_sharded_rainshaft_rhs,
    z_sharded_step,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _flagship(nz=16):
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=norms)
    config = rs.RainshaftConfig(spec=spec, nz=nz, zmax=3000.0, norms=norms, dt=1.0)
    return spec, norms, data, config


def _ic(config, n_col):
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    out = np.tile(ic[None], (n_col, 1, 1))
    # de-correlate columns
    out *= np.linspace(0.5, 1.5, n_col)[:, None, None]
    return out


def test_column_sharded_matches_single_device():
    spec, norms, data, config = _flagship()
    rhs = rs.make_rainshaft_rhs(config, data)
    mesh = make_mesh(("columns",))
    step = ensemble_rainshaft_step(rhs, config.dt, mesh)

    state = jnp.asarray(_ic(config, 16))
    sharded_state = jax.device_put(state, NamedSharding(mesh, P("columns")))
    out_sharded = np.asarray(jax.jit(step)(sharded_state))

    from cloudy_tpu import stepper

    out_local = np.asarray(
        stepper.ssprk33_step(rhs, state, jnp.asarray(0.0, state.dtype), config.dt)
    )
    np.testing.assert_allclose(out_sharded, out_local, rtol=1e-12)


def test_column_sharded_diagnostics_psum():
    """The psum'd diagnostic must equal the *independently computed*
    multi-mode total mass Σ_i M1^i — not just mode 0's M1. The initial state
    puts real mass into mode 1, so the old single-index bug
    (sum of ``out[..., 1]`` alone) fails this test."""
    spec, norms, data, config = _flagship()
    rhs = rs.make_rainshaft_rhs(config, data)
    mesh = make_mesh(("columns",))
    step = ensemble_rainshaft_step(
        rhs, config.dt, mesh, with_diagnostics=True, spec=spec
    )
    state = np.asarray(_ic(config, 8))
    # populate mode 1 (gamma) with 30% of mode 0's content so the promoted-
    # mass term is nonzero and NOT captured by mode 0's M1 index
    state[..., 3:6] = 0.3 * state[..., 0:3]
    state = jax.device_put(jnp.asarray(state), NamedSharding(mesh, P("columns")))
    out, total_mass = jax.jit(step)(state)
    out_np = np.asarray(out)
    expected = sum(
        out_np[..., spec.dist_moment_ind(i, 1)].sum()
        for i in range(spec.n_modes)
    )
    np.testing.assert_allclose(float(total_mass), float(expected), rtol=1e-10)
    # and the old bug is detectably wrong here
    mode0_only = out_np[..., 1].sum()
    assert abs(mode0_only - expected) / abs(expected) > 1e-3

    # omitting the spec with diagnostics on must raise, not silently
    # mis-count
    with pytest.raises(ValueError):
        ensemble_rainshaft_step(rhs, config.dt, mesh, with_diagnostics=True)


def test_z_sharded_halo_matches_unsharded():
    """The ppermute halo exchange must reproduce the single-device stencil
    bit-for-bit (deterministic collectives)."""
    spec, norms, data, config = _flagship(nz=16)
    mesh = make_mesh(("columns", "z"), (4, 2))

    rhs_local = make_z_sharded_rainshaft_rhs(
        spec, data, config.dz, config.vel, norms, axis_name="z"
    )
    step = jax.jit(z_sharded_step(rhs_local, config.dt, mesh))

    state = jnp.asarray(_ic(config, 8))
    sharded = jax.device_put(state, NamedSharding(mesh, P("columns", "z")))
    out_sharded = np.asarray(step(sharded))

    rhs_ref = rs.make_rainshaft_rhs(config, data)
    from cloudy_tpu import stepper

    out_ref = np.asarray(
        stepper.ssprk33_step(rhs_ref, state, jnp.asarray(0.0, state.dtype), config.dt)
    )
    np.testing.assert_allclose(out_sharded, out_ref, rtol=1e-12, atol=1e-20)


def test_halo_independent_of_coalescence_structurally():
    """Pins the overlap claim of halo.py:10-14: within one
    RHS evaluation, NOTHING expensive depends on the received halo — the
    ppermute result feeds only the linear stencil tail (concatenate /
    subtract / divide / output), so XLA's latency-hiding scheduler is free
    to overlap the ICI transfer with the coalescence compute. The test
    taints the ppermute outputs in the traced jaxpr and walks forward: if a
    future edit threads the halo through the closure or the coalescence
    bilinear form (serializing the pod's only collective), transcendental /
    call primitives appear downstream and this fails."""
    spec, norms, data, config = _flagship(nz=16)
    mesh = make_mesh(("columns", "z"), (4, 2))
    rhs_local = make_z_sharded_rainshaft_rhs(
        spec, data, config.dz, config.vel, norms, axis_name="z"
    )

    from jax import shard_map
    import functools

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P("columns", "z"),),
        out_specs=P("columns", "z"), check_vma=False,
    )
    def one_rhs(y):
        return rhs_local(y, jnp.asarray(0.0, y.dtype))

    state = jnp.asarray(_ic(config, 8))
    jaxpr = jax.make_jaxpr(one_rhs)(state)

    def _as_jaxpr(v):
        # params hold raw Jaxpr (shard_map) or ClosedJaxpr (pjit/scan/...)
        if hasattr(v, "eqns"):
            return v
        inner = getattr(v, "jaxpr", None)
        return inner if inner is not None and hasattr(inner, "eqns") else None

    def find_ppermute_jaxprs(jx, out):
        has = any(e.primitive.name == "ppermute" for e in jx.eqns)
        if has:
            out.append(jx)
        for e in jx.eqns:
            for v in e.params.values():
                vs = v if isinstance(v, (list, tuple)) else (v,)
                for vv in vs:
                    inner = _as_jaxpr(vv)
                    if inner is not None:
                        find_ppermute_jaxprs(inner, out)
        return out

    holders = find_ppermute_jaxprs(jaxpr.jaxpr, [])
    assert holders, "no ppermute found — halo exchange disappeared"

    allowed = {
        "concatenate", "sub", "add", "mul", "div", "neg", "select_n",
        "broadcast_in_dim", "reshape", "squeeze", "slice", "pad",
        "convert_element_type", "transpose", "copy",
    }
    def _flat_prims(jx, out):
        """All primitive names in a jaxpr, descending through call eqns
        (jit/pjit wrappers around e.g. jnp.where are transparent)."""
        for e in jx.eqns:
            sub = [
                _as_jaxpr(vv)
                for v in e.params.values()
                for vv in (v if isinstance(v, (list, tuple)) else (v,))
            ]
            sub = [s for s in sub if s is not None]
            if sub and e.primitive.name in ("jit", "pjit", "closed_call",
                                            "custom_jvp_call"):
                for s in sub:
                    _flat_prims(s, out)
            else:
                out.append(e.primitive.name)
        return out

    for jx in holders:
        tainted = set()
        downstream = []
        for e in jx.eqns:
            if e.primitive.name == "ppermute":
                tainted.update(id(v) for v in e.outvars)
                continue
            if any(id(v) in tainted for v in e.invars):
                tainted.update(id(v) for v in e.outvars)
                if e.primitive.name in ("jit", "pjit", "closed_call",
                                        "custom_jvp_call"):
                    for v in e.params.values():
                        for vv in (v if isinstance(v, (list, tuple)) else (v,)):
                            s = _as_jaxpr(vv)
                            if s is not None:
                                _flat_prims(s, downstream)
                else:
                    downstream.append(e.primitive.name)
        bad = [p for p in downstream if p not in allowed]
        assert not bad, f"halo feeds expensive/opaque ops: {bad}"
        # the tail is small — the stencil + output plumbing only
        assert len(downstream) < 40, downstream


def test_graft_entry_dryrun():
    """The driver's compile-check entry points: single-chip `entry()` jits
    and runs, and `dryrun_multichip(8)` compiles + executes the sharded
    production paths on the 8-device virtual mesh (a standalone, name-selectable test)."""
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == args[0].shape
    ge.dryrun_multichip(8)


@pytest.mark.slow
def test_whole_step_kernel_sharded_matches_unsharded():
    """The whole-SSPRK33-step kernel (Pallas interpreter) sharded over the
    8-device mesh equals its unsharded evaluation — the production step's
    sharding path."""
    from cloudy_tpu.ops import triton_coalescence as tc
    from cloudy_tpu.parallel.ensemble import ensemble_whole_step

    spec, norms, data, config = _flagship(nz=8)
    step = tc.make_triton_rainshaft_step_fn(
        data, config.vel, config.norms, nz=config.nz, dz=config.dz, dt=1.0,
        block_cols=1, interpret=True,
    )
    state = rs.to_soa(jnp.asarray(_ic(config, 8)))  # [n_tot, nz, 8]

    mesh = make_mesh(("columns",))
    sharded = jax.jit(ensemble_whole_step(step, mesh))
    y = jax.device_put(state, NamedSharding(mesh, P(None, None, "columns")))
    out_sharded = np.asarray(sharded(y))
    out_local = np.asarray(step(state))
    np.testing.assert_allclose(out_sharded, out_local, rtol=1e-12, atol=0.0)
