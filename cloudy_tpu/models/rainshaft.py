"""1-D rainshaft: coalescence + upwind finite-volume sedimentation.

Reference driver: test/examples/utils/rainshaft_helpers.jl:45-89. The
reference loops over z-levels in Python/Julia; here the column is a dense
``[nz, n_tot]`` array — coalescence is pointwise in z (one batched bilinear
form over all levels at once) and the sedimentation flux divergence is a
first-order upwind `jnp.diff` stencil with a zero-influx top boundary. Any
number of leading batch axes gives a column *ensemble* ``[..., nz, n_tot]``
for free — that is the shape the pod-scale sharded workload uses
(cloudy_tpu/parallel).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from cloudy_tpu.spec import SpectrumSpec, get_moments_normalizing_factors
from cloudy_tpu import distributions as pdists
from cloudy_tpu import stepper
from cloudy_tpu.coalescence import CoalescenceData, get_coal_ints
from cloudy_tpu.sedimentation import get_sedimentation_flux, normalized_velocity


@dataclasses.dataclass(frozen=True)
class RainshaftConfig:
    """One 1-D rainshaft scenario (reference rainshaft_single_gamma.jl)."""

    spec: SpectrumSpec
    nz: int = 128
    zmax: float = 3000.0
    norms: Tuple[float, float] = (1e6, 1e-9)
    #: terminal velocity v(x) = Σ c_k x^{e_k} (reference examples: 50 x^{1/6})
    vel: Tuple[Tuple[float, float], ...] = ((50.0, 1.0 / 6.0),)
    t_end: float = 1000.0
    dt: float = 1.0
    method: str = "ssprk33"
    save_every: int = 1

    @property
    def dz(self) -> float:
        return self.zmax / self.nz

    @property
    def z(self) -> np.ndarray:
        """Cell centers (reference uses an evenly spaced grid)."""
        return (np.arange(self.nz) + 0.5) * self.dz


def initial_condition(z, mom_amp):
    """Top-hat profile in z ∈ [0.5, 0.75)·zmax scaled per moment
    (reference `initial_condition`, rainshaft_helpers.jl:17-36)."""
    z = np.asarray(z)
    zmax = z.max()
    dz = z[1] - z[0]
    at = ((z >= 0.5 * zmax - dz / 2) & (z < 0.75 * zmax - dz / 2)).astype(np.float64)
    return at[:, None] * np.asarray(mom_amp)[None, :]


def make_rainshaft_rhs(
    config: RainshaftConfig,
    coal_data: Optional[CoalescenceData],
    coal_fn=None,
):
    """RHS over physical moments ``[..., nz, n_tot]``.

    Replicates rainshaft_helpers.jl:45-89: clip negative moments to zero,
    skip coalescence where all (normalized) moments < eps, per-level
    sedimentation flux, upwind divergence with zero flux at the top.
    ``coal_data=None`` gives a pure-sedimentation column (the validation
    case with a semi-analytic solution).

    ``coal_fn`` overrides the XLA coalescence path with a batched
    ``mom_norm [B, n_tot] -> [B, n_tot]`` tendency function — e.g. the
    RHS-only Triton kernel (`ops.triton_coalescence.make_triton_coal_fn`).
    """
    spec = config.spec
    mom_norms = get_moments_normalizing_factors(spec.nprogmoms, config.norms)
    vel_n = normalized_velocity(config.vel, config.norms)

    def rhs(mom, t):
        del t
        dtype = mom.dtype
        norm = jnp.asarray(mom_norms, dtype)
        eps = jnp.finfo(dtype).eps

        mom = jnp.maximum(mom, 0.0)  # negative clipping (:53)
        mom_n = mom / norm
        params = pdists.params_from_moments(spec, mom_n)

        if coal_fn is not None:
            flat = mom_n.reshape(-1, spec.n_tot)
            coal = coal_fn(flat).reshape(mom_n.shape) * norm
            empty = jnp.all(mom_n < eps, axis=-1, keepdims=True)
            coal = jnp.where(empty, 0.0, coal)
        elif coal_data is not None:
            coal = get_coal_ints(coal_data, params) * norm
            # empty-cell skip (:67-68): zero the source where every moment of
            # the level is below eps
            empty = jnp.all(mom_n < eps, axis=-1, keepdims=True)
            coal = jnp.where(empty, 0.0, coal)
        else:
            coal = jnp.zeros_like(mom)

        flux = get_sedimentation_flux(spec, params, vel_n) * norm  # [..., nz, n_tot]
        # upwind divergence, downward transport, zero influx at top (:80-86):
        # d m_i = -(F[i+1] - F[i]) / dz  with F[nz] = 0
        pad = [(0, 0)] * (flux.ndim - 2) + [(0, 1), (0, 0)]
        flux_top = jnp.pad(flux, pad)
        sedi = -(flux_top[..., 1:, :] - flux_top[..., :-1, :]) / config.dz

        return coal + sedi

    return rhs


def to_soa(state):
    """``[..., nz, n_tot]`` (framework layout) → level-major
    ``[n_tot, nz, C]`` (C = the flattened leading axes): each (moment,
    level) row holds every column contiguously — the production step's
    layout (`ops.triton_coalescence.make_triton_rainshaft_step_fn`)."""
    s = jnp.asarray(state)
    nz, n_tot = s.shape[-2:]
    return jnp.transpose(s.reshape(-1, nz, n_tot), (2, 1, 0))


def from_soa(state):
    """Level-major ``[n_tot, nz, C]`` → ``[C, nz, n_tot]``."""
    return jnp.transpose(jnp.asarray(state), (2, 1, 0))


def run_rainshaft(config: RainshaftConfig, rhs, mom_init):
    n_steps = int(round(config.t_end / config.dt))
    return stepper.integrate(
        rhs,
        jnp.asarray(mom_init, jnp.result_type(float)),
        0.0,
        config.dt,
        n_steps,
        method=config.method,
        save_every=config.save_every,
    )


def analytical_sol_sedimentation(config: RainshaftConfig, spec_family, ic, coeff, t):
    """Semi-analytic pure-sedimentation moment profiles at time t
    (reference `analytical_sol`, rainshaft_helpers.jl:102-125): each particle
    mass m falls at v(m) = c0 + c1·m^{1/6}; the solution advects the initial
    moment profile along characteristics z0 = z + v(m)·t and re-integrates
    moments over a high-resolution mass grid. Pure-numpy host-side validation
    helper (exponential/gamma closures inlined).

    - `ic`: [nz, n_mom] initial moments of a single mode
    - `coeff`: (c0, c1)
    """
    import math

    from cloudy_tpu.spec import Family

    z = config.z
    nz, nmom = ic.shape
    nm = 10000
    m_ = np.logspace(-5, 4, nm)
    eps = np.finfo(np.float64).eps

    def density_np(mom_z0, m):
        m0, m1 = mom_z0[0], mom_z0[1]
        if m0 <= eps or m1 <= eps:
            return 0.0
        if spec_family == Family.EXPONENTIAL:
            n, th = m0, m1 / m0
            return n / th * math.exp(-m / th)
        if spec_family == Family.GAMMA:
            m2 = mom_z0[2]
            mean = m1 / m0
            denom = m2 / m1 - mean
            k = min(max(mean / max(denom, eps), eps), 10.0)
            th = mean / k
            return (
                m0
                * m ** (k - 1.0)
                / th**k
                / math.gamma(k)
                * math.exp(-m / th)
            )
        raise ValueError(spec_family)

    def interp_ic(z0):
        # linear interpolation with linear extrapolation (reference uses
        # Line() extrapolation)
        return np.array(
            [np.interp(z0, z, ic[:, k]) for k in range(nmom)]
        )

    mom = np.zeros((nz, nmom))
    for i, z_ in enumerate(z):
        for j in range(1, nm - 1):
            m = m_[j]
            dm = (m_[j + 1] - m_[j - 1]) / 2
            v = coeff[0] + coeff[1] * m ** (1.0 / 6.0)
            z0 = z_ + v * t
            if z0 > z.max():
                continue
            mom_z0 = np.maximum(interp_ic(z0), 0.0)
            dens = density_np(mom_z0, m)
            if dens == 0.0:
                continue
            for k in range(nmom):
                mom[i, k] += m**k * dens * dm
    return mom
