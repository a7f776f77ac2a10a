"""Column-ensemble data parallelism via shard_map.

The pod-scale workload (BASELINE configs[4]) is 10^6+ independent rainshaft
columns. Columns do not couple, so the scaling design shards the leading
column axis over the mesh with `shard_map`: zero communication inside the
step, collectives only for diagnostics (psum of conservation sums). This is
the configuration that makes ≥80% scaling efficiency structural rather than
aspirational.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def shard_columns(
    step_fn: Callable,
    mesh: Mesh,
    axis_name: str = "columns",
):
    """Wrap a batched per-column step ``y -> y_next`` (leading axis =
    columns) so it runs sharded over `axis_name`. The wrapped function takes
    and returns a global array whose leading axis is sharded."""
    spec = P(axis_name)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
        check_vma=False,
    )
    def sharded(y):
        return step_fn(y)

    return sharded


def ensemble_whole_step(step_fn: Callable, mesh: Mesh, axis_name: str = "columns"):
    """Shard a whole-step function over the level-major state
    ``[n_tot, nz, n_columns]`` (`ops.triton_coalescence.make_triton_rainshaft_step_fn`)
    along its column axis. Levels never cross devices, so the upwind stencil
    stays local and the step contains zero collectives."""
    pspec = P(None, None, axis_name)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspec,),
        out_specs=pspec,
        check_vma=False,
    )
    def sharded(y):
        return step_fn(y)

    return sharded


def ensemble_rainshaft_step(
    rhs: Callable,
    dt: float,
    mesh: Mesh,
    axis_name: str = "columns",
    method: str = "ssprk33",
    with_diagnostics: bool = False,
    spec=None,
):
    """One sharded time step for a column ensemble state
    ``[n_columns, nz, n_tot]``.

    With `with_diagnostics=True` also returns the *global* total mass —
    Σ over every column, level and **mode** of that mode's M1 (flat index
    ``spec.dist_moment_ind(i, 1)``, the same index math as
    `utils.metrics.conservation_report`) — a cross-shard `psum`, the only
    collective in the step. `spec` (a `SpectrumSpec`) is required in that
    case: summing a single flat index would silently drop all mass promoted
    into higher modes."""
    from cloudy_tpu import stepper as _st

    step = _st.STEPPERS[method]
    pspec = P(axis_name)

    def local_step(y):
        return step(rhs, y, jnp.asarray(0.0, y.dtype), dt)

    if not with_diagnostics:
        return shard_columns(local_step, mesh, axis_name)

    if spec is None:
        raise ValueError(
            "with_diagnostics=True needs the SpectrumSpec to locate every "
            "mode's mass moment in the flat state vector"
        )
    mass_idx = tuple(spec.dist_moment_ind(i, 1) for i in range(spec.n_modes))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspec,),
        out_specs=(pspec, P()),
        check_vma=False,
    )
    def sharded(y):
        y_next = local_step(y)
        local_mass = sum(jnp.sum(y_next[..., o]) for o in mass_idx)
        total = jax.lax.psum(local_mass, axis_name)
        return y_next, total

    return sharded
