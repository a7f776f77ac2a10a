"""cloudy_tpu — a moment-based cloud-microphysics solver.

A from-scratch JAX framework (XLA, Pallas through Triton on the GPU) with the
capabilities of CliMA/Cloudy.jl (reference layer map in SURVEY.md): moment
closures over particle-mass
distributions, collision--coalescence (Smoluchowski) moment tendencies,
condensation/evaporation, sedimentation, and 0-D box / 1-D rainshaft / parcel
drivers — all expressed as dense batched arrays under `jit`, scaling from one
column to millions of columns via `vmap`/`shard_map` over a device mesh.

Design notes
------------
- State is a flat vector of prognostic moments per column (the reference's
  concatenated per-mode moment vector, src/helper_functions.jl:13-32), plus a
  static `SpectrumSpec` describing the family and prognostic-moment count of
  each mode.
- Distribution parameters are a dense ``[..., n_modes, 3]`` array; the closure
  inversion (reference src/ParticleDistributions/ParticleDistributions.jl:456-541)
  is closed-form and branch-free (`jnp.where`).
- The analytical coalescence path (reference src/Sources/Coalescence.jl:115-455)
  is compiled to a single batched bilinear form: one ``[B, D^2] x [D^2, n_out]``
  matmul per step.
- Everything is jit-compiled with static shapes; time integration is an SSP-RK
  loop under `lax.scan`.
"""

from cloudy_tpu.spec import (
    Family,
    SpectrumSpec,
    get_dist_moment_ind,
    get_dist_moments_ind_range,
    get_moments_normalizing_factors,
)
from cloudy_tpu import kernels
from cloudy_tpu import distributions
from cloudy_tpu import coalescence
from cloudy_tpu import coalescence_numerical
from cloudy_tpu import condensation
from cloudy_tpu import sedimentation
from cloudy_tpu import stepper
from cloudy_tpu import calibrate

__version__ = "0.1.0"

__all__ = [
    "Family",
    "SpectrumSpec",
    "get_dist_moment_ind",
    "get_dist_moments_ind_range",
    "get_moments_normalizing_factors",
    "kernels",
    "distributions",
    "coalescence",
    "coalescence_numerical",
    "condensation",
    "sedimentation",
    "stepper",
    "calibrate",
]
