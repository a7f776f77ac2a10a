"""Pallas kernels through Triton for the fused coalescence body.

Both kernels run `ops.row_coalescence`'s physics body on ``[1, block_cols]``
rows: each program owns a block of columns on its lanes.

- `make_triton_rainshaft_step_fn`: the whole SSPRK33 rainshaft step. Each
  program walks its columns' levels from the top down in a `fori_loop`.
  Upwind transport needs only the level above, so level i's y → u1 → u2 →
  y_next needs nothing but the three stage fluxes F(y), F(u1), F(u2) of
  level i+1, which the loop carries; no in-block shift is left. The state is
  read and written once per step, and no intermediate leaves the registers.
- `make_triton_coal_fn`: the coalescence tendencies of normalized moments
  (the RHS-only operation bench.py measures).

Triton tensors must have power-of-two sizes: moment rows are loaded one row
at a time, block_cols is a power of two, and the static quadrature tiles are
padded to a power of two with zero weights (`row_coalescence._pad_pow2`).
Each thread owns one column: num_warps = block_cols / 32 (two columns per
thread doubled the step time on the H100; PERF.md).
Column counts that are not a multiple of block_cols are padded with empty
columns. ``interpret=True`` runs the kernels in the Pallas interpreter (the
CPU tests).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from cloudy_tpu.coalescence import CoalescenceData
from cloudy_tpu.ops import row_coalescence as rc


def _check_block(block_cols: int):
    if block_cols < 1 or block_cols & (block_cols - 1):
        raise ValueError(f"block_cols={block_cols} is not a power of two")


def _call(kernel, out_shape, block_cols, n_blocks, in_specs, out_spec,
          interpret, name):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_blocks,),
        in_specs=in_specs,
        out_specs=out_spec,
        backend="triton",
        compiler_params=pltr.CompilerParams(
            num_warps=max(block_cols // 32, 1), num_stages=1
        ),
        interpret=interpret,
        name=name,
    )


def _grid_specs(grid_inputs, dtype):
    args = [jnp.asarray(g, dtype) for g in grid_inputs]
    specs = [pl.BlockSpec(g.shape, lambda i: (0, 0)) for g in grid_inputs]
    return args, specs


def make_triton_rainshaft_step_fn(
    data: CoalescenceData,
    vel: Sequence[Tuple[float, float]],
    norms: Tuple[float, float],
    nz: int,
    dz: float,
    dt: float,
    block_cols: int = 128,
    interpret: bool = False,
    kernel_scale: bool = False,
    **coal_kwargs,
):
    """One whole SSPRK33 rainshaft step.

    ``fn(y [n_tot, nz, C]) -> [n_tot, nz, C]``: the level-major state (each
    (moment, level) row holds the C columns contiguously; see
    `models.rainshaft.to_soa`) advanced by one step of length `dt`, with the
    semantics of `models.rainshaft.make_rainshaft_rhs` +
    `stepper.ssprk33_step` (pinned in tests/test_pallas.py).

    ``kernel_scale=True`` adds a second operand: ``fn(y, scale)`` multiplies
    the coalescence tendency by `scale` (a scalar or one value per column)
    inside every RHS evaluation. Because the Q/R/S assembly is LINEAR in the
    kernel tensor (the F2/msh matrices are kernel-independent partial
    moments), ``scale = s`` is exactly equivalent to building `data` from
    the kernel tensor scaled by ``s`` — pinned in tests/test_pallas.py. This
    is the calibration hook: an EKI ensemble drives the production step as
    its forward model."""
    _check_block(block_cols)
    local, grid_inputs = rc.make_local_rhs(data, vel, norms, **coal_kwargs)
    n_tot = data.spec.n_tot
    inv_dz = 1.0 / float(dz)
    dt = float(dt)
    TB = block_cols

    def kernel(y_ref, *refs):
        if kernel_scale:
            s_row, grid_refs = refs[0][...], refs[1:-1]
        else:
            s_row, grid_refs = None, refs[:-1]
        out_ref = refs[-1]
        zeros = tuple(jnp.zeros((1, TB), y_ref.dtype) for _ in range(n_tot))

        def level(k, carry):
            lev = nz - 1 - k
            y = [y_ref[o, pl.ds(lev, 1), :] for o in range(n_tot)]
            out, fluxes = rc.ssprk33_rows(
                y, lambda r: local(r, grid_refs, s_row), carry, dt, inv_dz
            )
            for o in range(n_tot):
                out_ref[o, pl.ds(lev, 1), :] = out[o]
            return tuple(tuple(f) for f in fluxes)

        jax.lax.fori_loop(jnp.int32(0), jnp.int32(nz), level, (zeros,) * 3)

    def step(y, scale=None):
        C = y.shape[2]
        Cp = -(-C // TB) * TB
        if Cp != C:
            y = jnp.pad(y, ((0, 0), (0, 0), (0, Cp - C)))
        args = [y]
        in_specs = [pl.BlockSpec((n_tot, nz, TB), lambda i: (0, 0, i))]
        if kernel_scale:
            s = jnp.broadcast_to(jnp.asarray(scale, y.dtype), (C,))
            args.append(jnp.pad(s, (0, Cp - C)).reshape(1, Cp))
            in_specs.append(pl.BlockSpec((1, TB), lambda i: (0, i)))
        g_args, g_specs = _grid_specs(grid_inputs, y.dtype)
        out = _call(
            kernel,
            jax.ShapeDtypeStruct(y.shape, y.dtype),
            TB,
            Cp // TB,
            in_specs + g_specs,
            pl.BlockSpec((n_tot, nz, TB), lambda i: (0, 0, i)),
            interpret,
            "rainshaft_ssprk33_step",
        )(*args, *g_args)
        return out[:, :, :C]

    if kernel_scale:
        return jax.jit(step)
    return jax.jit(lambda y: step(y))


def make_triton_coal_fn(
    data: CoalescenceData,
    block_cols: int = 256,
    interpret: bool = False,
    **coal_kwargs,
):
    """``fn(mom_norm [B, n_tot]) -> [B, n_tot]``: coalescence tendencies of
    normalized moments; ``fn.soa`` takes and returns the moment-major
    ``[n_tot, B]`` layout. ``coal_kwargs`` go to
    `row_coalescence._make_coal_body`: ``quad_rule`` "reference" keeps the
    reference's log-grid Simpson rule (bit-identical to the XLA path),
    "gauss" uses `gauss_nodes` Gauss–Legendre points on the same interval;
    `thr_newton_iters`/`thr_gammainc_iters` control the MovingThreshold
    gamma-percentile Newton inversion (defaults match
    distributions.compute_thresholds); ``f2_exact`` (default
    ``data.f2_exact``) switches gamma/exponential F2 to the exact
    factorization M_p·M_q·P(2k+p+q, T/θ) (coalescence._msh_matrix_gamma_exact)."""
    _check_block(block_cols)
    n_tot = data.spec.n_tot
    body, grid_inputs = rc._make_coal_body(data, **coal_kwargs)
    TB = block_cols

    def kernel(mom_ref, *refs):
        grid_refs, out_ref = refs[:-1], refs[-1]
        rows = [mom_ref[pl.ds(o, 1), :] for o in range(n_tot)]
        acc, _, _ = body(rows, grid_refs)
        for o in range(n_tot):
            out_ref[pl.ds(o, 1), :] = (
                acc[o] if acc[o] is not None else jnp.zeros_like(rows[o])
            )

    @jax.jit
    def fn_soa(mom_t):
        B = mom_t.shape[1]
        Bp = -(-B // TB) * TB
        if Bp != B:
            mom_t = jnp.pad(mom_t, ((0, 0), (0, Bp - B)))
        g_args, g_specs = _grid_specs(grid_inputs, mom_t.dtype)
        out = _call(
            kernel,
            jax.ShapeDtypeStruct(mom_t.shape, mom_t.dtype),
            TB,
            Bp // TB,
            [pl.BlockSpec((n_tot, TB), lambda i: (0, i))] + g_specs,
            pl.BlockSpec((n_tot, TB), lambda i: (0, i)),
            interpret,
            "coalescence_rhs",
        )(mom_t, *g_args)
        return out[:, :B]

    def fn(mom):
        """[B, n_tot] -> [B, n_tot] (framework layout)."""
        return fn_soa(mom.T).T

    fn.soa = fn_soa
    return fn
