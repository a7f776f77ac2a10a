"""Vertical (z) domain decomposition with ppermute halo exchange.

The column-sharded layout (ensemble.py) needs no halo. This module provides
the z-*sharded* variant mandated by BASELINE ("halo-exchanged sedimentation
overlapped with quadrature"): the vertical axis is split into contiguous
blocks across a mesh axis, and the first-order upwind sedimentation stencil
``dM_i = −(F[i+1] − F[i])/dz`` (reference rainshaft_helpers.jl:80-86) needs
exactly one cell of flux halo from the shard above.

Overlap structure: the halo `ppermute` is issued on the *flux* (cheap,
computed first) before the expensive coalescence bilinear form; XLA's
latency-hiding scheduler overlaps the transfer with that compute because
nothing in the coalescence path depends on the received halo.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from cloudy_tpu.spec import SpectrumSpec, get_moments_normalizing_factors
from cloudy_tpu import distributions as pdists
from cloudy_tpu.coalescence import CoalescenceData, get_coal_ints
from cloudy_tpu.sedimentation import get_sedimentation_flux, normalized_velocity


def halo_from_above(x_block, axis_name: str, fill=0.0):
    """Receive the bottom cell of the shard above along `axis_name`.

    z blocks are ordered bottom → top along the mesh axis; shard d receives
    ``x_block[..., 0:1, :]`` from shard d+1; the topmost shard receives
    `fill` (zero-influx boundary). Single-element `ppermute` — one hop on the
    device ring."""
    n = jax.lax.axis_size(axis_name)
    perm = [(d, d - 1) for d in range(1, n)]
    bottom = x_block[..., :1, :]
    recv = jax.lax.ppermute(bottom, axis_name, perm)
    idx = jax.lax.axis_index(axis_name)
    return jnp.where(idx == n - 1, jnp.full_like(recv, fill), recv)


def make_z_sharded_rainshaft_rhs(
    spec: SpectrumSpec,
    coal_data: Optional[CoalescenceData],
    dz: float,
    vel,
    norms: Tuple[float, float],
    axis_name: str = "z",
):
    """Local-block rainshaft RHS for state blocks ``[..., nz_local, n_tot]``
    running inside `shard_map` with z split along `axis_name`.

    Identical physics to models.rainshaft.make_rainshaft_rhs; only the
    topmost flux cell crosses the shard boundary. The ppermute is issued
    before the coalescence compute so the transfer hides under it.
    """
    mom_norms = get_moments_normalizing_factors(spec.nprogmoms, norms)
    vel_n = normalized_velocity(vel, norms)

    def rhs(mom, t):
        del t
        dtype = mom.dtype
        norm = jnp.asarray(mom_norms, dtype)
        eps = jnp.finfo(dtype).eps

        mom = jnp.maximum(mom, 0.0)
        mom_n = mom / norm
        params = pdists.params_from_moments(spec, mom_n)

        # flux first; issue the halo exchange immediately …
        flux = get_sedimentation_flux(spec, params, vel_n) * norm
        flux_above = halo_from_above(flux, axis_name)  # [..., 1, n_tot]

        # … then the expensive part (overlaps with the halo transfer)
        if coal_data is not None:
            coal = get_coal_ints(coal_data, params) * norm
            empty = jnp.all(mom_n < eps, axis=-1, keepdims=True)
            coal = jnp.where(empty, 0.0, coal)
        else:
            coal = jnp.zeros_like(mom)

        flux_up = jnp.concatenate([flux[..., 1:, :], flux_above], axis=-2)
        sedi = -(flux_up - flux) / dz
        return coal + sedi

    return rhs


def z_sharded_step(
    rhs,
    dt: float,
    mesh: Mesh,
    col_axis: str = "columns",
    z_axis: str = "z",
    method: str = "ssprk33",
):
    """One SSP-RK step of a column ensemble ``[n_col, nz, n_tot]`` with
    columns sharded on `col_axis` AND z sharded on `z_axis` (2-D mesh)."""
    from cloudy_tpu import stepper as _st

    step = _st.STEPPERS[method]
    spec_inout = P(col_axis, z_axis)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec_inout,),
        out_specs=spec_inout,
        check_vma=False,
    )
    def sharded(y):
        return step(rhs, y, jnp.asarray(0.0, y.dtype), dt)

    return sharded
