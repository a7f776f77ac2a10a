"""Collision–coalescence moment tendencies (analytical path).

Array-native redesign of the reference's analytical SCE path
(src/Sources/Coalescence.jl:45-455). The reference evaluates Q (cross-mode
gain), R (loss) and S (self-collision split by a mass threshold) as nested
NTuple sums per mode pair and moment order. Here the *entire* Q/R/S assembly
is precomputed at init into two static weight tensors so the per-step work is
one batched bilinear form:

    coal_ints[o] =  Σ_{jp,kq} WB[o, jp, kq] · Mf[jp] · Mf[kq]
                  + Σ_{i,p,q} WF[o, i, p, q] · F2[i, p, q]

with Mf the flattened dense diagnostic moment matrix ([n_modes, P+2] moments
per mode) and F2 the per-mode "finite 2-D integrals" (autoconversion partial
integrals, clamped). On a batch of columns this is a single
``[B, D²] × [D², n_out]`` matmul plus one
small ``[M, G] × [G, M]`` Simpson/incomplete-gamma contraction per thresholded
mode for F2.

Equivalence to the reference term structure (verified in
tests/test_coalescence.py against an independent dense reimplementation):

    dM_m^k/dt = Σ_{j<k} Q_jk[m] − Σ_j R_jk[m] + S_1k[m] + S_2,k−1[m]
    Q_jk[m] = Σ_{a,b,c≤m} kc[j,k,a,b] C(m,c) M[j,a+c] M[k,b+m−c]   (:283-309)
    R_jk[m] = Σ_{a,b}     kc[j,k,a,b] M[j,a] M[k,b+m]              (:334-351)
    S_1k[m] = ½ Σ kc[k,k,a,b] C(m,c) F2[k][a+c, b+m−c]             (:398-424)
    S_2k[m] = ½ Σ kc[k,k,a,b] C(m,c) (M[k,a+c] M[k,b+m−c] − F2[k][…]) (:426-455)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from cloudy_tpu.spec import Family, SpectrumSpec
from cloudy_tpu import distributions as pdists
from cloudy_tpu.kernels import CoalescenceTensor
from cloudy_tpu.ops import special
from cloudy_tpu.ops.simpson import simpson_even_fast_weights_dynamic
from cloudy_tpu.distributions import threshold_log_grid

#: f32 matmuls at full precision: a GPU may otherwise run them in TF32
_HI = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class CoalescenceData:
    """Init-time precompute for the analytical path — the reference's
    `CoalescenceData` (src/Sources/Coalescence.jl:45-106) plus the fused
    assembly weight tensors.

    Numpy members are trace-time constants (closed over by jit functions).
    """

    spec: SpectrumSpec
    #: polynomial order + 1 of the kernel tensors
    P: int
    #: number of diagnostic moment columns per mode (= P + 2)
    M: int
    #: normalized per-pair kernel tensors, shape [N, N, P, P]
    kernels: np.ndarray
    #: FixedThreshold: normalized mass thresholds [N] (np.inf = no threshold)
    #: MovingThreshold: percentiles [N]
    thresholds: np.ndarray
    #: whether thresholds are runtime percentiles (reference MovingThreshold)
    moving: bool
    #: reference N_2d_ints (src/Sources/Coalescence.jl:70-76)
    n_2d_ints: Tuple[int, ...]
    #: reference N_mom_max
    n_mom_max: int
    #: bilinear assembly weights [n_out, N*M, N*M]
    wb: np.ndarray
    #: finite-2d-int assembly weights [n_out, N, M, M]
    wf: np.ndarray
    #: Simpson grid points per thresholded mode (static shape)
    n_points_max: int
    #: iterations for the incomplete-gamma evaluation
    gammainc_iters: int
    #: evaluate gamma/exponential F2 by the exact factorization instead of
    #: the reference's log-grid Simpson quadrature (see _msh_matrix_gamma_exact)
    f2_exact: bool = False
    #: > 0 switches the F2 incomplete-gamma evaluations to the fixed
    #: Gauss–Legendre scheme with this many nodes (`special.gammainc_gl`) —
    #: PROVEN uniform accuracy over the reachable (a, x) domain (2.6e-7 at
    #: 12 nodes for a ∈ [4, 26]), unlike fixed-iteration series/CF whose
    #: error peaks at x ≈ a (1.7e-2 at 12 iterations, a = 26). 0 keeps the
    #: series/CF pair at `gammainc_iters` (the f64 reference-parity default).
    gammainc_gl_nodes: int = 0
    #: > 0 switches lognormal F2 matrices to the density-recentered GL
    #: window rule with this many nodes (`_msh_matrix_lognormal_window`) —
    #: the proven-bound fast path (measured worst case 4.0e-4 of the clamp
    #: scale at 16 nodes over the reachable (μ, σ, T) domain,
    #: tests/test_coalescence.py). 0 keeps the reference-shaped log grid
    #: (`_msh_matrix_lognormal`), whose nodes span the FULL [1e-5·T, T]
    #: interval regardless of where the density mass sits — worst case
    #: ~0.87 of the clamp scale at 12 Gauss nodes when σ is small and the
    #: bulk occupies a fraction of the interval (measured; the reference's
    #: own nested-quadgk path has no such error but is not expressible with
    #: static shapes).
    lognorm_gl_nodes: int = 0


def _build_assembly_weights(spec: SpectrumSpec, kernels: np.ndarray, M: int):
    """Fold the reference's Q/R/S nested sums into dense weight tensors."""
    N = spec.n_modes
    P = kernels.shape[-1]
    n_out = spec.n_tot
    D = N * M
    wb = np.zeros((n_out, D, D))
    wf = np.zeros((n_out, N, M, M))

    def fl(j, p):
        return j * M + p

    for k in range(N):
        for m in range(spec.nprogmoms[k]):
            o = spec.offsets[k] + m
            # Q: gain into k from collisions of modes j < k with k
            for j in range(k):
                for a in range(P):
                    for b in range(P):
                        kc = kernels[j, k, a, b]
                        if kc == 0.0:
                            continue
                        for c in range(m + 1):
                            wb[o, fl(j, a + c), fl(k, b + m - c)] += kc * math.comb(m, c)
            # R: loss of k by collision with every mode j (incl. j = k)
            for j in range(N):
                for a in range(P):
                    for b in range(P):
                        wb[o, fl(j, a), fl(k, b + m)] -= kernels[j, k, a, b]
            # S_1k: self-collision gain staying in mode k
            for a in range(P):
                for b in range(P):
                    kc = kernels[k, k, a, b]
                    if kc == 0.0:
                        continue
                    for c in range(m + 1):
                        wf[o, k, a + c, b + m - c] += 0.5 * kc * math.comb(m, c)
            # S_2,k−1: promotion gain from mode k−1's self-collisions
            if k >= 1:
                for a in range(P):
                    for b in range(P):
                        kc = kernels[k - 1, k - 1, a, b]
                        if kc == 0.0:
                            continue
                        for c in range(m + 1):
                            wb[o, fl(k - 1, a + c), fl(k - 1, b + m - c)] += (
                                0.5 * kc * math.comb(m, c)
                            )
                            wf[o, k - 1, a + c, b + m - c] -= 0.5 * kc * math.comb(m, c)
    return wb, wf


def build_coalescence_data(
    spec: SpectrumSpec,
    kernel: Union[CoalescenceTensor, Sequence[Sequence[CoalescenceTensor]]],
    dist_thresholds: Sequence[float],
    norms: Tuple[float, float] = (1.0, 1.0),
    moving: bool = False,
    n_points_max: Optional[int] = None,
    gammainc_iters: Optional[int] = None,
    f2_exact: bool = False,
    gammainc_gl_nodes: Optional[int] = None,
    lognorm_gl_nodes: Optional[int] = None,
    fast_tier: bool = False,
) -> CoalescenceData:
    """Precompute everything static for `get_coal_ints`.

    - `kernel`: one `CoalescenceTensor` for all pairs, or an N×N matrix of
      tensors (the Long-kernel case, reference Coalescence.jl:55-104).
    - `dist_thresholds`: FixedThreshold → physical mass thresholds (np.inf for
      "no threshold"); MovingThreshold (`moving=True`) → percentiles.
    - `norms`: (number, mass) scales; kernel tensors are normalized here and
      fixed thresholds divided by the mass norm (reference :63-84).
    - `f2_exact`: gamma/exponential autoconversion matrices via the exact
      factorization F2(p,q) = M_p·M_q·P(2k+p+q, T/θ) (one incomplete gamma
      per column instead of a quadrature grid — the fast path; default False
      keeps the reference's Simpson semantics bit-for-bit).
    - `fast_tier=True` is shorthand for the full proven-bound production
      configuration: ``f2_exact=True, gammainc_gl_nodes=12,
      gammainc_iters=12, lognorm_gl_nodes=16`` (each bound pinned in
      tests/test_special.py / tests/test_coalescence.py; the benched and
      golden-gated configuration). Explicit kwargs still win: the three
      numeric knobs default to the None sentinel, so ANY explicitly passed
      value — including 0 (series/CF gammainc) or 128 — is honored under
      fast_tier.
    """
    if fast_tier:
        f2_exact = True
        gammainc_gl_nodes = 12 if gammainc_gl_nodes is None else gammainc_gl_nodes
        lognorm_gl_nodes = 16 if lognorm_gl_nodes is None else lognorm_gl_nodes
        gammainc_iters = 12 if gammainc_iters is None else gammainc_iters
    else:
        gammainc_gl_nodes = 0 if gammainc_gl_nodes is None else gammainc_gl_nodes
        lognorm_gl_nodes = 0 if lognorm_gl_nodes is None else lognorm_gl_nodes
        gammainc_iters = 128 if gammainc_iters is None else gammainc_iters
    N = spec.n_modes
    if isinstance(kernel, CoalescenceTensor):
        kmat = [[kernel for _ in range(N)] for _ in range(N)]
    else:
        kmat = [list(row) for row in kernel]
    P = kmat[0][0].array.shape[0]
    kernels = np.stack(
        [
            np.stack([kmat[j][k].normalized(norms).array for k in range(N)])
            for j in range(N)
        ]
    )  # [j, k, P, P]

    thresholds = np.asarray(list(dist_thresholds), dtype=np.float64)
    if len(thresholds) != N:
        raise ValueError("need one threshold per mode")
    if not moving:
        thresholds = thresholds / norms[1]

    M = P + 2
    nprog = spec.nprogmoms
    n_mom_max = max(nprog) + (P - 1)
    n_2d = tuple(
        (P - 1) + (max(nprog[i], nprog[i + 1]) if i < N - 1 else nprog[i])
        for i in range(N)
    )
    wb, wf = _build_assembly_weights(spec, kernels, M)

    if n_points_max is None:
        # FixedThreshold: exact bin counts are known; MovingThreshold: a
        # normalized threshold T ≤ 1 always gives 75 bins (x_lo = 1e-5·T), so
        # 128 covers thresholds up to ~3.4e3 mass-norm units.
        finite = thresholds[np.isfinite(thresholds)]
        if moving or finite.size == 0:
            n_points_max = 128
        else:
            tmax = float(np.max(finite))
            x_lo = min(1e-5, 1e-5 * tmax)
            n_points_max = int(np.floor(15 * np.log10(tmax / x_lo))) + 1

    return CoalescenceData(
        spec=spec,
        P=P,
        M=M,
        kernels=kernels,
        thresholds=thresholds,
        moving=moving,
        n_2d_ints=n_2d,
        n_mom_max=n_mom_max,
        wb=wb,
        wf=wf,
        n_points_max=n_points_max,
        gammainc_iters=gammainc_iters,
        f2_exact=f2_exact,
        gammainc_gl_nodes=gammainc_gl_nodes,
        lognorm_gl_nodes=lognorm_gl_nodes,
    )


# --------------------------------------------------------------------------
# finite 2-D integrals (the autoconversion partial integrals)
# --------------------------------------------------------------------------


def _gammainc_top(a, x, iters: int, gl_nodes: int, log_x=None, gln=None):
    """Top-order incomplete gamma of the F2 downward recurrences: the
    Gauss–Legendre scheme when `gl_nodes` > 0 (proven uniform accuracy over
    the reachable a ∈ [2, 26] domain — see special.gammainc_gl), else the
    series/CF pair at `iters` iterations (reference-parity default).
    ``gln`` (= lgamma(a)) lets the exact-F2 caller reuse its delta chain's
    Lanczos evaluation."""
    if gl_nodes:
        return special.gammainc_gl(a, x, n_nodes=gl_nodes, gln=gln)
    return special.gammainc_impl(a, x, n_iters=iters, log_x=log_x)


def _msh_matrix_gamma(n, theta, k, thr, M: int, n_points_max: int, iters: int,
                      gl_nodes: int = 0):
    """Simpson/incomplete-gamma evaluation of the full M×M matrix of
    ∫∫ x^p x'^q f f' over the triangle x + x' < thr, for one gamma-family
    mode (exponential is the k = 1 special case — identical closed forms,
    reference ParticleDistributions.jl:567-612).

    Shapes: params [...] scalars; returns [..., M, M]. The incomplete gammas
    for consecutive orders use the *downward* recurrence

        P(a, x) = P(a+1, x) + x^a e^{−x} / Γ(a+1):

    one continued-fraction / series evaluation at the TOP order a = k+M−1 per
    grid point, then M−1 additions of positive Poisson terms — forward-stable
    at every order (the upward variant subtracts and loses ~1.5 digits per
    order where x ≪ a; pinned by
    tests/test_coalescence.py::test_gammainc_downward_recurrence_m_scaling at
    M = 8). The Poisson terms delta(a) = x^a e^{−x}/Γ(a+1) are built upward
    multiplicatively (delta(a+1) = delta(a) · x/(a+1), no divisions by x), so
    the whole chain costs one exp/lgamma.
    """
    dtype = theta.dtype
    x, dx, n_bins = threshold_log_grid(thr, n_points_max, dtype)
    w = simpson_even_fast_weights_dynamic(n_points_max, n_bins, dtype)
    j = jnp.arange(1, n_points_max + 1)
    mask = (j <= n_bins[..., None]).astype(dtype)

    th = theta[..., None]
    rem = jnp.maximum(thr[..., None] - x, 0.0) / th
    logx = jnp.log(x)

    a0 = k[..., None]
    log_rem = jnp.log(jnp.maximum(rem, jnp.finfo(dtype).tiny))
    # Poisson terms delta(a0+q) for q = 0..M−2, upward multiplicative chain
    delta = special.exp(a0 * log_rem - rem - special.lgamma(a0 + 1.0))
    delta = jnp.where(rem > 0.0, delta, 0.0)
    deltas = [delta]
    for q in range(1, M - 1):
        deltas.append(deltas[-1] * rem / (a0 + q))
    # top order directly, then accumulate downward (log_rem shared with the
    # Poisson-term chain above)
    gi = _gammainc_top(a0 + (M - 1.0), rem, iters, gl_nodes, log_x=log_rem)
    gis = [gi]
    for q in range(M - 2, -1, -1):
        gi = jnp.clip(gi + deltas[q], 0.0, 1.0)
        gis.append(gi)
    gis.reverse()
    GI = jnp.stack(gis, axis=-2)  # [..., M(q), G]

    # integrand rows: Y[p] = w · mask · x^{p+k} e^{−x/θ}
    base = special.exp(k[..., None] * logx - x / th) * w * mask
    ys = [base]
    for _ in range(1, M):
        ys.append(ys[-1] * x)
    Y = jnp.stack(ys, axis=-2)  # [..., M(p), G]

    raw = jnp.einsum("...pg,...qg->...pq", Y, GI, precision=_HI) * dx[..., None, None]

    # prefactor per q: n² θ^{q−k} Γ(q+k) / Γ(k)²
    q = jnp.arange(M, dtype=dtype)
    logth = jnp.log(th)
    lgk = special.lgamma(k)[..., None]
    pref = (n[..., None] ** 2) * special.exp(
        (q - k[..., None]) * logth
        + special.lgamma(q + k[..., None])
        - 2.0 * lgk
    )
    return raw * pref[..., None, :]


def _msh_matrix_gamma_exact(n, theta, k, thr, M: int, iters: int,
                            gl_nodes: int = 0):
    """Exact closed form of the gamma/exponential autoconversion matrix.

    The 2-D partial integral the reference evaluates by nested quadrature
    (moment_source_helper, ParticleDistributions.jl:567-612) factors exactly
    for gamma-family densities: substituting s = x + x', u = x/s in

        ∫∫_{x+x'<T} x^p x'^q f(x) f(x') dx dx'
          = n²/(Γ(k)²θ^{2k}) ∫₀^T s^{p+q+2k−1} e^{−s/θ} ds
                             ∫₀^1 u^{p+k−1}(1−u)^{q+k−1} du
          = M_p · M_q · P(p + q + 2k, T/θ),

    i.e. the u-integral is the complete Beta function and
    B(p+k, q+k)·Γ(p+q+2k) = Γ(p+k)Γ(q+k) — equivalently, the sum of two
    independent Gamma(p+k, θ) and Gamma(q+k, θ) tilted variables is
    Gamma(p+q+2k, θ). One regularized-incomplete-gamma evaluation at the top
    order 2k + 2M − 2 per column plus the forward-stable *downward*
    recurrence P(a, x) = P(a+1, x) + x^a e^{−x}/Γ(a+1) yields every order
    p + q = 0..2M−2; no quadrature grid, no quadrature error (validated
    against scipy and the Simpson path in tests/test_coalescence.py).

    Shapes: params [...] scalars; returns [..., M, M].
    """
    dtype = theta.dtype
    tiny = jnp.finfo(dtype).tiny
    # P(a, x) saturates to 1 far below x = 1e6 for every order here; the
    # clamp keeps degenerate columns (θ → eps) finite (same clamp as
    # special.gammainc_impl).
    x = jnp.minimum(thr / theta, 1e6)
    log_x = jnp.log(jnp.maximum(x, tiny))
    a0 = 2.0 * k
    # Poisson terms d_j = x^{2k+j} e^{−x}/Γ(2k+j+1), j = 0..2M−3, built
    # upward multiplicatively from one exp/lgamma. The GL fast tier uses
    # the 1-divide Stirling-shift lgamma (< 4e-9 abs, far inside the
    # path's 2.6e-7 gammainc bound; Lanczos costs 8 divides); the f64
    # parity tier keeps Lanczos.
    lgam = special.lgamma_stirling if gl_nodes else special.lgamma
    lga01 = lgam(a0 + 1.0)
    d = special.exp(a0 * log_x - x - lga01)
    d = jnp.where(x > 0.0, d, 0.0)
    ds = [d]
    prod = None
    for j in range(1, 2 * M - 2):
        ds.append(ds[-1] * x / (a0 + j))
        prod = (a0 + j) if prod is None else prod * (a0 + j)
    # top order directly, then downward (adds positive terms — stable);
    # lgamma(a0+2M−2) = lgamma(a0+1) + log((a0+1)…(a0+2M−3)) reuses the
    # delta chain's Lanczos — identical arithmetic to the Pallas kernel
    gi = _gammainc_top(
        a0 + (2.0 * M - 2.0), x, iters, gl_nodes, log_x=log_x,
        gln=None if prod is None else lga01 + jnp.log(prod),
    )
    gis = [gi]
    for j in range(2 * M - 3, -1, -1):
        gi = jnp.clip(gi + ds[j], 0.0, 1.0)
        gis.append(gi)
    gis.reverse()  # gis[s] = P(2k + s, T/θ)

    # analytic moments M_p = n θ^p Γ(p+k)/Γ(k) by upward recurrence
    ms = [n]
    for p in range(1, M):
        ms.append(ms[-1] * theta * (k + p - 1.0))
    mp = jnp.stack(ms, axis=-1)  # [..., M]
    gpq = jnp.stack(
        [jnp.stack([gis[p + q] for q in range(M)], axis=-1) for p in range(M)],
        axis=-2,
    )  # [..., M, M]
    return mp[..., :, None] * mp[..., None, :] * gpq


def _msh_matrix_lognormal(n, mu, sig, thr, M: int, n_points_max: int,
                          erf_iters: int = 128, erf_fast: bool = False):
    """Same reduction for a lognormal mode: inner integral is the exact
    partial moment n exp(qμ + q²σ²/2) Φ((ln(T−x) − μ − qσ²)/σ); outer
    integral on the reference log grid (the reference used nested adaptive
    quadrature, ParticleDistributions.jl:614-625). Φ is evaluated through
    `special.erf_impl` — the Pallas-safe erf — so this XLA path and the fused
    Pallas kernel are bit-identical. `erf_fast` switches to the rational
    `special.erf_approx` (proven 1.5e-7 bound, ~10x fewer slot-weighted ops
    per grid point) — the production fast path."""
    dtype = mu.dtype
    x, dx, n_bins = threshold_log_grid(thr, n_points_max, dtype)
    w = simpson_even_fast_weights_dynamic(n_points_max, n_bins, dtype)
    j = jnp.arange(1, n_points_max + 1)
    mask = (j <= n_bins[..., None]).astype(dtype)

    mu_, sig_ = mu[..., None], sig[..., None]
    tiny = jnp.finfo(dtype).tiny
    logx = jnp.log(jnp.maximum(x, tiny))
    fx = special.exp(-((logx - mu_) ** 2) / (2.0 * sig_**2)) / (
        x * sig_ * float(np.sqrt(2.0 * np.pi))
    )
    rem = jnp.maximum(thr[..., None] - x, 0.0)
    logrem = jnp.log(jnp.maximum(rem, tiny))

    q = jnp.arange(M, dtype=dtype)[:, None]  # [M, 1]
    z = (logrem[..., None, :] - mu_[..., None, :] - q * sig_[..., None, :] ** 2) / (
        sig_[..., None, :] * float(np.sqrt(2.0))
    )
    erf_z = (
        special.erf_approx(z) if erf_fast
        else special.erf_impl(z, n_iters=erf_iters)
    )
    pm = special.exp(
        q * mu_[..., None, :] + 0.5 * q**2 * sig_[..., None, :] ** 2
    ) * 0.5 * (1.0 + erf_z)
    pm = jnp.where(rem[..., None, :] > 0.0, pm, 0.0)  # [..., M(q), G]

    ys = [x * fx * w * mask]
    for _ in range(1, M):
        ys.append(ys[-1] * x)
    Y = jnp.stack(ys, axis=-2)  # [..., M(p), G]

    raw = jnp.einsum("...pg,...qg->...pq", Y, pm, precision=_HI) * dx[..., None, None]
    return raw * (n[..., None, None] ** 2)


#: half-width of the lognormal window rule in σ units (tail mass beyond
#: 6σ ≈ 1e-9 — negligible at the rule's 4e-4 pinned bound)
LOGNORM_WINDOW_SIGMA = 6.0


def _msh_matrix_lognormal_window(n, mu, sig, thr, M: int, gl_nodes: int):
    """Density-recentered Gauss–Legendre evaluation of the lognormal
    autoconversion matrix — the proven-bound fast path.

    The reference-shaped grid (`_msh_matrix_lognormal`) spreads its nodes
    over the FULL [1e-5·T, T] log interval; when σ is small the density
    bulk occupies a sliver of it and the rule's worst-case error reaches
    ~0.87 of the clamp scale M_p·M_q (measured vs adaptive quadrature).
    In u = log x the order-p outer integrand is exactly
    ``e^{pu}·N(u; μ, σ²)·pm_q(T−e^u)`` — a Gaussian of KNOWN center and
    width times a bounded monotone factor — so the correct window is

        [μ − Wσ,  min(log T, μ + Mσ² + Wσ)],  W = 6

    (the +Mσ² covers the center shift of the highest order; an empty window
    — log T below the support — correctly collapses to F2 = 0). GL-16 on
    this window has measured worst-case error 4.0e-4 of the clamp scale
    over the reachable domain μ ∈ [−8, 2.5] × σ ∈ [0.15, 1.5] × T ∈
    {fixed ∈ [0.05, 5], moving percentiles} (pinned in
    tests/test_coalescence.py; 1.3e-2 at 12 nodes). Same arithmetic as the
    Pallas kernel's `_f2_lognormal_window` — parity is exact.

    Note the rule drops the reference's 1e-5·T lower cutoff (which alone
    truncates Φ(−2.6) ≈ 5e-3 of mass at μ ≈ −8); this path trades
    bit-parity with the reference grid for a PROVEN bound, like the exact
    gamma factorization before it.
    """
    dtype = mu.dtype
    tiny = jnp.finfo(dtype).tiny
    vg, wg = np.polynomial.legendre.leggauss(gl_nodes)
    # cast the GL base nodes to the compute dtype: strong f64 numpy arrays
    # would silently promote the whole window path under jax_enable_x64
    vg, wg = jnp.asarray(vg, dtype), jnp.asarray(wg, dtype)
    W = LOGNORM_WINDOW_SIGMA

    lo = mu - W * sig  # [...]
    hi = jnp.minimum(
        jnp.log(jnp.maximum(thr, tiny)), mu + M * sig**2 + W * sig
    )
    half = jnp.maximum(hi - lo, 0.0) * 0.5
    center = lo + half

    u = center[..., None] + half[..., None] * vg  # [..., G]
    x = special.exp(u)
    sig_ = sig[..., None]
    mu_ = mu[..., None]
    g0 = (
        half[..., None]
        * wg
        * special.exp(-((u - mu_) ** 2) / (2.0 * sig_**2))
        / (sig_ * float(np.sqrt(2.0 * np.pi)))
    )

    rem = jnp.maximum(thr[..., None] - x, 0.0)
    logrem = jnp.log(jnp.maximum(rem, tiny))
    q = jnp.arange(M, dtype=dtype)[:, None]  # [M, 1]
    z = (logrem[..., None, :] - mu_[..., None, :] - q * sig_[..., None, :] ** 2) / (
        sig_[..., None, :] * float(np.sqrt(2.0))
    )
    pm = special.exp(
        q * mu_[..., None, :] + 0.5 * q**2 * sig_[..., None, :] ** 2
    ) * 0.5 * (1.0 + special.erf_approx(z))
    pm = jnp.where(rem[..., None, :] > 0.0, pm, 0.0)  # [..., M(q), G]

    ys = [g0]  # order p rows: g0 · x^p
    for _ in range(1, M):
        ys.append(ys[-1] * x)
    Y = jnp.stack(ys, axis=-2)  # [..., M(p), G]

    raw = jnp.einsum("...pg,...qg->...pq", Y, pm, precision=_HI)
    return raw * (n[..., None, None] ** 2)


def get_finite_2d_integrals(
    data: CoalescenceData, params, mom_matrix, thresholds=None
) -> jnp.ndarray:
    """Per-mode clamped autoconversion matrices, shape [..., N, M, M].

    Reference `get_finite_2d_integrals` (src/Sources/Coalescence.jl:200-244):
    entry (p, q) of mode i is

        0                                 if M_p·M_q < eps or p,q ≥ N_2d_ints[i]
        M_p·M_q                           if i is the last mode or thr = ∞
        min(M_p·M_q, msh(i, p', q'))      otherwise, (p', q') = sorted (p, q)

    `thresholds` (optional, [..., N]) overrides the static ones — used by the
    MovingThreshold path.
    """
    spec = data.spec
    N, M = spec.n_modes, data.M
    dtype = jnp.asarray(params).dtype
    eps = jnp.finfo(dtype).eps

    mm = mom_matrix[..., :, :, None] * mom_matrix[..., :, None, :]  # [..., N, M, M]

    p_idx = np.arange(M)[:, None]
    q_idx = np.arange(M)[None, :]

    out = []
    for i in range(N):
        mmi = mm[..., i, :, :]
        in_range = np.asarray(
            (p_idx < data.n_2d_ints[i]) & (q_idx < data.n_2d_ints[i])
        )
        static_no_thr = (not data.moving) and (
            i == N - 1 or not np.isfinite(data.thresholds[i])
        )
        last_mode = i == N - 1
        if static_no_thr or last_mode:
            f2 = mmi
        else:
            if thresholds is not None:
                thr = thresholds[..., i]
            else:
                thr = jnp.asarray(data.thresholds[i], dtype)
                thr = jnp.broadcast_to(thr, mmi.shape[:-2])
            # guard: finite positive threshold for the grid math, mask after
            thr_finite = jnp.isfinite(thr) & (thr > 0.0)
            thr_safe = jnp.where(thr_finite, thr, 1.0)
            fam = spec.families[i]
            n, p1, p2 = (params[..., i, j] for j in range(3))
            if fam in (Family.EXPONENTIAL, Family.GAMMA):
                kk = p2 if fam == Family.GAMMA else jnp.ones_like(n)
                if data.f2_exact:
                    msh = _msh_matrix_gamma_exact(
                        n, p1, kk, thr_safe, M, data.gammainc_iters,
                        gl_nodes=data.gammainc_gl_nodes,
                    )
                else:
                    msh = _msh_matrix_gamma(
                        n, p1, kk, thr_safe, M, data.n_points_max,
                        data.gammainc_iters,
                        gl_nodes=data.gammainc_gl_nodes,
                    )
            elif fam == Family.LOGNORMAL:
                if data.lognorm_gl_nodes:
                    msh = _msh_matrix_lognormal_window(
                        n, p1, p2, thr_safe, M, data.lognorm_gl_nodes
                    )
                else:
                    msh = _msh_matrix_lognormal(
                        n, p1, p2, thr_safe, M, data.n_points_max,
                        erf_iters=data.gammainc_iters,
                        # gammainc_gl_nodes > 0 selects the proven-bound
                        # fast special-function set (GL gammainc +
                        # rational erf)
                        erf_fast=data.gammainc_gl_nodes > 0,
                    )
            elif fam == Family.MONODISPERSE:
                pq = jnp.asarray(p_idx + q_idx, dtype)
                msh = jnp.where(
                    p1[..., None, None] < thr_safe[..., None, None] / 2.0,
                    (n[..., None, None] ** 2) * p1[..., None, None] ** pq,
                    0.0,
                )
            else:
                raise ValueError(fam)
            # symmetrize from the upper triangle (reference computes j ≤ k
            # then mirrors, :207-240)
            upper = jnp.where(
                np.asarray(p_idx <= q_idx), msh, jnp.swapaxes(msh, -1, -2)
            )
            f2 = jnp.minimum(mmi, upper)
            f2 = jnp.where(thr_finite[..., None, None], f2, mmi)
        f2 = jnp.where((mmi < eps) | ~in_range, 0.0, f2)
        out.append(f2)
    return jnp.stack(out, axis=-3)


# --------------------------------------------------------------------------
# the per-step tendency
# --------------------------------------------------------------------------


def get_coal_ints(data: CoalescenceData, params, wb=None, wf=None) -> jnp.ndarray:
    """Coalescence tendencies of all prognostic moments, shape [..., n_tot].

    Input `params` is the dense distribution-parameter array
    ``[..., n_modes, 3]`` (from `distributions.params_from_moments`); any
    leading batch axes map over columns. Reference entry point
    `get_coal_ints(::AnalyticalCoalStyle, …)` (src/Sources/Coalescence.jl:115-150)
    including the MovingThreshold variant (:152-185) when
    ``data.moving`` (per-step percentile thresholds, :164).

    `wb`/`wf` optionally override the static assembly weight tensors with
    traced arrays of the same shapes — the hook `make_kernel_diff_coal_fn`
    uses to differentiate through the kernel coefficients.
    """
    spec = data.spec
    params = jnp.asarray(params)
    dtype = params.dtype

    mom = pdists.moments_matrix(spec, params, data.M)  # [..., N, M]

    thresholds = None
    if data.moving:
        thresholds = pdists.compute_thresholds(
            spec, params, tuple(data.thresholds),
            fast_gl_nodes=data.gammainc_gl_nodes,
        )
    f2 = get_finite_2d_integrals(data, params, mom, thresholds)

    batch = mom.shape[:-2]
    D = spec.n_modes * data.M
    mf = mom.reshape(batch + (D,))
    outer = mf[..., :, None] * mf[..., None, :]
    if wb is None:
        wb = data.wb
    if wf is None:
        wf = data.wf
    wb = jnp.asarray(wb, dtype).reshape(spec.n_tot, D * D).T
    wf = jnp.asarray(wf, dtype).reshape(
        spec.n_tot, spec.n_modes * data.M * data.M
    ).T
    out = jnp.matmul(outer.reshape(batch + (D * D,)), wb, precision=_HI)
    out = out + jnp.matmul(f2.reshape(batch + (-1,)), wf, precision=_HI)
    return out


def make_kernel_diff_coal_fn(data: CoalescenceData):
    """Differentiable-in-the-kernel coalescence tendencies — the calibration
    surface (a capability the reference lacks: CliMA calibrates Cloudy.jl
    with gradient-free ensemble Kalman methods precisely because the Julia
    stack has no adjoint).

    `_build_assembly_weights` is LINEAR in the normalized per-pair kernel
    coefficient array ``kernels [N, N, P, P]``, so the folded Q/R/S weight
    tensors can be re-contracted inside a traced function from a one-hot
    basis precomputed here:

        wb(kernels) = Σ_{jkab} kernels[j,k,a,b] · WB_basis[j,k,a,b]

    Returns ``fn(params, kernels) -> [..., n_tot]`` where `kernels` is a
    traced array in NORMALIZED units (what `CoalescenceData.kernels`
    stores); gradients flow to every coefficient. Validated against central
    finite differences in tests/test_autodiff.py.
    """
    spec = data.spec
    N, P, M = spec.n_modes, data.P, data.M
    wb_basis = np.zeros((N, N, P, P) + data.wb.shape)
    wf_basis = np.zeros((N, N, P, P) + data.wf.shape)
    for j in range(N):
        for k in range(N):
            for a in range(P):
                for b in range(P):
                    onehot = np.zeros((N, N, P, P))
                    onehot[j, k, a, b] = 1.0
                    wb1, wf1 = _build_assembly_weights(spec, onehot, M)
                    wb_basis[j, k, a, b] = wb1
                    wf_basis[j, k, a, b] = wf1
    wb_basis = wb_basis.reshape(N * N * P * P, -1)
    wf_basis = wf_basis.reshape(N * N * P * P, -1)

    def fn(params, kernels):
        kflat = jnp.asarray(kernels).reshape(-1)
        wb = jnp.matmul(
            kflat, jnp.asarray(wb_basis, kflat.dtype), precision=_HI
        ).reshape(data.wb.shape)
        wf = jnp.matmul(
            kflat, jnp.asarray(wf_basis, kflat.dtype), precision=_HI
        ).reshape(data.wf.shape)
        return get_coal_ints(data, params, wb=wb, wf=wf)

    return fn


def make_coal_rhs(data: CoalescenceData, norms: Tuple[float, float] = (1.0, 1.0)):
    """RHS over *physical* flat moments: normalize → invert closure →
    tendencies → denormalize (reference box driver `rhs_coal!`,
    test/examples/utils/box_model_helpers.jl:29-53)."""
    from cloudy_tpu.spec import get_moments_normalizing_factors

    mom_norms = get_moments_normalizing_factors(data.spec.nprogmoms, norms)

    def rhs(mom_flat):
        mom_flat = jnp.asarray(mom_flat)
        norm = jnp.asarray(mom_norms, mom_flat.dtype)
        params = pdists.params_from_moments(data.spec, mom_flat / norm)
        return get_coal_ints(data, params) * norm

    return rhs
