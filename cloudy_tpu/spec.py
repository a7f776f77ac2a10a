"""Static spectrum specification and moment-vector indexing.

Array-native replacement of the reference's moment-vector helpers
(src/helper_functions.jl:13-58): maps (mode i, moment m) <-> flat index in the
concatenated moment vector, and provides per-moment normalization factors
(src/helper_functions.jl:40-53).

Everything here is *static* (Python ints / tuples / numpy): it fixes array
shapes at trace time so the whole step compiles to one XLA program with no
dynamic shapes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np


class Family(enum.IntEnum):
    """Distribution family of one spectral mode.

    Mirrors the reference's four primitive particle distributions
    (src/ParticleDistributions/ParticleDistributions.jl:42-159).
    """

    EXPONENTIAL = 0
    GAMMA = 1
    LOGNORMAL = 2
    MONODISPERSE = 3


#: Number of prognostic moments (= settable parameters, reference
#: `nparams`, src/ParticleDistributions/ParticleDistributions.jl:425-427).
NPROG = {
    Family.EXPONENTIAL: 2,
    Family.GAMMA: 3,
    Family.LOGNORMAL: 3,
    Family.MONODISPERSE: 2,
}


@dataclasses.dataclass(frozen=True)
class SpectrumSpec:
    """Static description of an N-mode particle spectrum.

    The single source of truth for array shapes: number of modes, family of
    each mode, prognostic moment counts and flat-vector offsets.

    Hashable, so it can be a `static_argnums` argument to `jax.jit`.
    """

    families: Tuple[Family, ...]

    def __post_init__(self):
        object.__setattr__(
            self, "families", tuple(Family(f) for f in self.families)
        )
        if len(self.families) == 0:
            raise ValueError("spectrum needs at least one mode")

    @property
    def n_modes(self) -> int:
        return len(self.families)

    @property
    def nprogmoms(self) -> Tuple[int, ...]:
        """Prognostic moments per mode — reference `NProgMoms`."""
        return tuple(NPROG[f] for f in self.families)

    @property
    def n_tot(self) -> int:
        """Length of the flat prognostic moment vector."""
        return sum(self.nprogmoms)

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Start index of each mode's block in the flat moment vector."""
        out, acc = [], 0
        for n in self.nprogmoms:
            out.append(acc)
            acc += n
        return tuple(out)

    def dist_moment_ind(self, i: int, m: int) -> int:
        """Flat index of moment ``m`` (0-based) of mode ``i`` (0-based).

        Reference `get_dist_moment_ind` (src/helper_functions.jl:13-24),
        converted to 0-based indexing.
        """
        if not 0 <= m < self.nprogmoms[i]:
            raise ValueError(
                f"moment index {m} out of range for mode {i} "
                f"(has {self.nprogmoms[i]} prognostic moments)"
            )
        return self.offsets[i] + m

    def dist_moments_ind_range(self, i: int) -> range:
        """Index range of mode ``i``'s block — reference
        `get_dist_moments_ind_range` (src/helper_functions.jl:27-35)."""
        return range(self.offsets[i], self.offsets[i] + self.nprogmoms[i])

    def moment_orders_flat(self) -> np.ndarray:
        """Moment order (0,1,2,...) of each flat-vector entry."""
        return np.concatenate([np.arange(n) for n in self.nprogmoms])

    def mode_of_flat(self) -> np.ndarray:
        """Mode index of each flat-vector entry."""
        return np.concatenate(
            [np.full(n, i) for i, n in enumerate(self.nprogmoms)]
        )


def get_dist_moment_ind(nprogmoms: Tuple[int, ...], i: int, m: int) -> int:
    """Flat index of the m-th moment of the i-th mode (both 0-based).

    Functional equivalent of reference src/helper_functions.jl:13-24.
    """
    if not 0 <= m < nprogmoms[i]:
        raise ValueError("moment index out of range")
    return sum(nprogmoms[:i]) + m


def get_dist_moments_ind_range(nprogmoms: Tuple[int, ...], i: int) -> range:
    """Flat index range of the i-th mode's prognostic moments (0-based).

    Functional equivalent of reference src/helper_functions.jl:27-35.
    """
    start = sum(nprogmoms[:i])
    return range(start, start + nprogmoms[i])


def get_moments_normalizing_factors(
    nprogmoms: Tuple[int, ...], norms: Tuple[float, float]
) -> np.ndarray:
    """Per-moment normalization factors ``norms[0] * norms[1]**order``.

    Reference `get_moments_normalizing_factors`
    (src/helper_functions.jl:40-53): the j-th prognostic moment of every mode
    is scaled by the number scale times the mass scale to the moment order.
    Returned as a numpy array so it constant-folds under jit.
    """
    if norms[0] <= 0 or norms[1] <= 0:
        raise ValueError("norms must be positive")
    return np.concatenate(
        [norms[0] * norms[1] ** np.arange(n, dtype=np.float64) for n in nprogmoms]
    )
