"""Collision–coalescence via direct numerical quadrature (validation path).

Reference: `get_coal_ints(::NumericalCoalStyle, …)`
(src/Sources/Coalescence.jl:470-708) — doubly-nested *adaptive* quadgk with an
arbitrary kernel *function*. Adaptive quadrature is structurally impossible
under XLA (data-dependent work), so this path uses fixed-node Gauss–Legendre
panels: a log-spaced outer grid spanning the distributions' support and a
scaled inner grid (y = s·x for the triangular gain integrals), sized so the
fixed-node result matches the adaptive one far below the reference's
validation tolerances. Everything is batched einsums — the kernel matrix
``K[x_i, y_j]`` contraction is a plain matmul.

Integral structure (0-based mode indices, m = moment order):
  Q[m,j,k] (j<k) = ∫₀^∞ x^m ∫₀^x ½K(x−y,y)[f_j(x−y)f_k(y)+f_k(x−y)f_j(y)] dy dx
  R[m,j,k]       = ∫₀^∞ x^m f_k(x) ∫₀^∞ K(x,y) f_j(y) dy dx
  S1/S2[m,k]     = ∫₀^∞ x^m w_k(x) / (1−w_k(x)) · ½∫₀^x K(x−y,y) f_k(x−y) f_k(y) dy dx
with w_k the normalized-density weighting function (reference :624-642).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from cloudy_tpu.spec import Family, SpectrumSpec
from cloudy_tpu import distributions as pdists
from cloudy_tpu.ops.gauss import gauss_legendre

#: f32 matmuls at full precision: a GPU may otherwise run them in TF32
_HI = jax.lax.Precision.HIGHEST


def support_bounds(spec: SpectrumSpec, params) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-batch (x_lo, x_hi) covering the numerically relevant support of
    every mode (tail quantiles from closed forms; generous margins)."""
    params = jnp.asarray(params)
    dtype = params.dtype
    los, his = [], []
    for i, fam in enumerate(spec.families):
        n, p1, p2 = (params[..., i, j] for j in range(3))
        if fam == Family.EXPONENTIAL:
            lo, hi = p1 * 1e-8, p1 * 40.0
        elif fam == Family.GAMMA:
            lo = p1 * jnp.exp(jnp.log(jnp.asarray(1e-12, dtype)) / jnp.maximum(p2, 0.05))
            lo = jnp.maximum(lo, p1 * 1e-12)
            hi = p1 * (p2 + 30.0 * jnp.sqrt(p2) + 40.0)
        elif fam == Family.LOGNORMAL:
            lo, hi = jnp.exp(p1 - 8.0 * p2), jnp.exp(p1 + 8.0 * p2)
        elif fam == Family.MONODISPERSE:
            lo, hi = p1 * 0.5, p1 * 2.5
        # inactive modes (n = 0) must not drag the bounds
        active = n > 0.0
        los.append(jnp.where(active, lo, jnp.inf))
        his.append(jnp.where(active, hi, 0.0))
    x_lo = jnp.minimum(jnp.stack(los, -1).min(-1), 1e30)
    x_hi = jnp.maximum(jnp.stack(his, -1).max(-1), 1e-30)
    x_lo = jnp.minimum(x_lo, x_hi * 1e-12)
    # keep the log-grid finite in f32 for all-empty states (no-op in f64)
    tiny = jnp.finfo(dtype).tiny
    return jnp.maximum(x_lo, tiny), jnp.maximum(2.0 * x_hi, 4.0 * tiny)


def _densities_all(spec, params, x):
    """density of every mode at x[..., G...]: returns [..., N, G...]."""
    mats = []
    for i, fam in enumerate(spec.families):
        n, p1, p2 = (
            params[..., i, j][..., *([None] * (x.ndim - params.ndim + 2))]
            for j in range(3)
        )
        mats.append(pdists._density_one_mode(fam, n, p1, p2, x, normed=False))
    return jnp.stack(mats, axis=params.ndim - 2)


def _normed_densities_all(spec, params, x):
    mats = []
    for i, fam in enumerate(spec.families):
        n, p1, p2 = (
            params[..., i, j][..., *([None] * (x.ndim - params.ndim + 2))]
            for j in range(3)
        )
        mats.append(pdists._density_one_mode(fam, n, p1, p2, x, normed=True))
    return jnp.stack(mats, axis=params.ndim - 2)


def weighting_fn(spec: SpectrumSpec, params, x, k: int) -> jnp.ndarray:
    """Fraction of total *normalized* density in modes ≤ k at particle mass x
    (reference `weighting_fn`, src/Sources/Coalescence.jl:624-642)."""
    if not 0 <= k < spec.n_modes:
        raise ValueError("k out of range")
    nd = _normed_densities_all(spec, params, jnp.asarray(x))
    denom = jnp.sum(nd, axis=-2 if nd.ndim > 1 else 0)
    num = jnp.sum(nd[..., : k + 1, :] if nd.ndim > 1 else nd[: k + 1], axis=-2 if nd.ndim > 1 else 0)
    return jnp.where(denom == 0.0, 0.0, num / denom)


def get_coal_ints_numerical(
    spec: SpectrumSpec,
    params,
    kernel_func,
    n_outer: int = 256,
    n_inner: int = 96,
) -> jnp.ndarray:
    """Tendencies of all prognostic moments, shape [..., n_tot].

    Fixed-node counterpart of reference Coalescence.jl:470-489; `kernel_func`
    is a `kernels.KernelFunction` (or any callable K(x, y) on arrays).
    """
    spec_nm = spec.n_modes
    params = jnp.asarray(params)
    dtype = params.dtype
    n_mom = max(spec.nprogmoms)

    # kernel non-smoothness: split quadrature panels at each kink (and at 2x
    # each kink, where the triangular inner integral's breakpoints cross) so
    # the fixed Gauss rule keeps spectral convergence (the reference's
    # adaptive quadgk handles these by subdivision). `n_outer`/`n_inner`
    # stay the TOTAL node budgets — they are divided among the panels.
    kinks = tuple(float(t) for t in getattr(kernel_func, "x_kinks", ()))

    x_lo, x_hi = support_bounds(spec, params)

    # outer log grid: x = exp(u), Jacobian folded into weights
    if kinks:
        outer_cuts = sorted({c for t in kinks for c in (t, 2.0 * t)})
        n_po = len(outer_cuts) + 1
        xu, wu = gauss_legendre(max(n_outer // n_po, 8))
        xu = jnp.asarray(xu, dtype)
        wu = jnp.asarray(wu, dtype)
        lo, hi = jnp.log(x_lo)[..., None], jnp.log(x_hi)[..., None]
        edges = (
            [lo]
            + [jnp.clip(jnp.log(jnp.asarray(c, dtype)), lo, hi) for c in outer_cuts]
            + [hi]
        )
        Xp, Wp = [], []
        for a, b in zip(edges[:-1], edges[1:]):
            u = a + 0.5 * (b - a) * (xu + 1.0)
            Xp.append(jnp.exp(u))
            Wp.append(0.5 * (b - a) * wu * jnp.exp(u))
        X = jnp.concatenate(Xp, axis=-1)  # [..., Gx]
        WX = jnp.concatenate(Wp, axis=-1)
    else:
        xu, wu = gauss_legendre(n_outer)
        xu = jnp.asarray(xu, dtype)
        wu = jnp.asarray(wu, dtype)
        lo, hi = jnp.log(x_lo)[..., None], jnp.log(x_hi)[..., None]
        U = lo + 0.5 * (hi - lo) * (xu + 1.0)
        X = jnp.exp(U)  # [..., Gx]
        WX = 0.5 * (hi - lo) * wu * X

    # inner scaled grid s ∈ (0, 1): y = s x. With kinks, the inner integrand
    # breaks at y = t and y = x − t, i.e. s = t/x and 1 − t/x — per-x panel
    # edges [..., Gx, n_panels+1], nodes/weights [..., Gx, Gs_total].
    if kinks:
        n_pi = 2 * len(kinks) + 1
        su, ws = gauss_legendre(max(n_inner // n_pi, 8))
        su = jnp.asarray(0.5 * (np.asarray(su) + 1.0), dtype)  # (0,1)
        ws = jnp.asarray(0.5 * np.asarray(ws), dtype)
        cuts = jnp.sort(
            jnp.stack(
                [
                    jnp.clip(c, 0.0, 1.0)
                    for t in kinks
                    for c in (t / X, 1.0 - t / X)
                ],
                axis=-1,
            ),
            axis=-1,
        )  # [..., Gx, 2*n_kinks]
        zeros = jnp.zeros_like(X)[..., None]
        iedges = jnp.concatenate([zeros, cuts, zeros + 1.0], axis=-1)
        Sp, Wsp = [], []
        for pidx in range(n_pi):
            a = iedges[..., pidx, None]
            b = iedges[..., pidx + 1, None]
            Sp.append(a + (b - a) * su)
            Wsp.append((b - a) * ws)
        S = jnp.concatenate(Sp, axis=-1)  # [..., Gx, Gs]
        WS = jnp.concatenate(Wsp, axis=-1)
    else:
        su, ws = gauss_legendre(n_inner)
        S = jnp.asarray(0.5 * (su + 1.0), dtype)  # (0,1)
        WS = jnp.asarray(0.5 * ws, dtype)

    F = _densities_all(spec, params, X)  # [..., N, Gx]
    NF = _normed_densities_all(spec, params, X)
    denom = jnp.sum(NF, axis=-2)
    cum = jnp.cumsum(NF, axis=-2)
    wfrac = jnp.where(denom[..., None, :] == 0.0, 0.0, cum / denom[..., None, :])
    # [..., N(k), Gx]

    Xpow = jnp.stack([X**m for m in range(n_mom)], axis=-2)  # [..., n_mom, Gx]

    # ---- R: inner ∫ K(x,y) f_j(y) dy on the same log grid -----------------
    Kxy = kernel_func(X[..., :, None], X[..., None, :])  # [..., Gx, Gy]
    A = jnp.einsum("...xy,...jy,...y->...jx", Kxy, F, WX, precision=_HI)  # [..., N, Gx]
    R = jnp.einsum(
        "...x,...mx,...kx,...jx->...mjk", WX, Xpow, F, A, precision=_HI
    )

    # ---- Q and S: triangular inner integrals y = s·x ----------------------
    XS = X[..., :, None] * S  # y nodes      [..., Gx, Gs]
    XR = X[..., :, None] * (1.0 - S)  # x − y  [..., Gx, Gs]
    Kq = kernel_func(XR, XS)
    D = _densities_all(spec, params, XR)  # [..., N, Gx, Gs]
    E = _densities_all(spec, params, XS)
    # half-kernel with inner weights and the y = s·x Jacobian x
    KW = 0.5 * Kq * WS  # [..., Gx, Gs]

    # cross-mode gain: G[j,k,x] symmetric under j<->k by construction
    Gjk = jnp.einsum("...xs,...jxs,...kxs->...jkx", KW, D, E, precision=_HI)
    Gjk = Gjk + jnp.swapaxes(Gjk, -3, -2)
    # Σ_x WX x^{m+1} G   (extra x = inner Jacobian)
    Q = jnp.einsum(
        "...x,...mx,...x,...jkx->...mjk", WX, Xpow, X, Gjk, precision=_HI
    )

    # self-collision gain per mode
    Gkk = jnp.einsum("...xs,...kxs,...kxs->...kx", KW, D, E, precision=_HI)
    S1 = jnp.einsum(
        "...x,...mx,...x,...kx,...kx->...mk", WX, Xpow, X, wfrac, Gkk,
        precision=_HI,
    )
    Stot = jnp.einsum(
        "...x,...mx,...x,...kx->...mk", WX, Xpow, X, Gkk, precision=_HI
    )
    S2 = Stot - S1

    # ---- gated assembly (reference :479-488 + zero-structure :503-622) ----
    out = []
    for k in range(spec_nm):
        for m in range(spec.nprogmoms[k]):
            acc = -jnp.sum(R[..., m, :, k], axis=-1)
            qsum = jnp.sum(Q[..., m, :k, k], axis=-1) if k > 0 else 0.0
            acc = acc + qsum + S1[..., m, k]
            if k > 0:
                acc = acc + S2[..., m, k - 1]
            out.append(acc)
    return jnp.stack(out, axis=-1)


# ---------------------------------------------------------------------------
# reference-shaped integrand probes (for structural tests; reference :644-708)
# ---------------------------------------------------------------------------


def q_integrand_inner(spec, params, x, y, j, k, kernel_func):
    if j == k:
        raise AssertionError("q_integrand called on j==k, should call s instead")
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    d = _densities_all(spec, params, jnp.stack([x - y, y]))
    return 0.5 * kernel_func(x - y, y) * (d[j, 0] * d[k, 1] + d[k, 0] * d[j, 1])


def q_integrand_outer(spec, params, x, j, k, kernel_func, moment_order, n_inner=96):
    su, ws = gauss_legendre(n_inner)
    s = 0.5 * (su + 1.0)
    w = 0.5 * ws
    x = jnp.asarray(x)
    vals = q_integrand_inner(spec, params, x, x * s, j, k, kernel_func)
    return x**moment_order * x * jnp.sum(w * vals)


def r_integrand_inner(spec, params, x, y, j, k, kernel_func):
    d = _densities_all(spec, params, jnp.stack([jnp.asarray(x), jnp.asarray(y)]))
    return kernel_func(x, y) * d[k, 0] * d[j, 1]


def r_integrand_outer(spec, params, x, j, k, kernel_func, moment_order, n_nodes=256):
    x_lo, x_hi = support_bounds(spec, params)
    xu, wu = gauss_legendre(n_nodes)
    u = jnp.log(x_lo) + 0.5 * (jnp.log(x_hi) - jnp.log(x_lo)) * (xu + 1.0)
    y = jnp.exp(u)
    wy = 0.5 * (jnp.log(x_hi) - jnp.log(x_lo)) * wu * y
    d = _densities_all(spec, params, y)
    inner = jnp.sum(wy * kernel_func(jnp.asarray(x), y) * d[j], axis=-1)
    dx = _densities_all(spec, params, jnp.asarray(x))
    return jnp.asarray(x) ** moment_order * dx[k] * inner


def s_integrand_inner(spec, params, x, k, kernel_func, moment_order, n_inner=96):
    su, ws = gauss_legendre(n_inner)
    s = 0.5 * (su + 1.0)
    w = 0.5 * ws
    x = jnp.asarray(x)
    y = x * s
    d1 = _densities_all(spec, params, x - y)
    d2 = _densities_all(spec, params, y)
    vals = 0.5 * kernel_func(x - y, y) * d1[k] * d2[k]
    return x**moment_order * x * jnp.sum(w * vals)


def s_integrand1(spec, params, x, k, kernel_func, moment_order):
    return weighting_fn(spec, params, x, k) * s_integrand_inner(
        spec, params, x, k, kernel_func, moment_order
    )


def s_integrand2(spec, params, x, k, kernel_func, moment_order):
    return (1.0 - weighting_fn(spec, params, x, k)) * s_integrand_inner(
        spec, params, x, k, kernel_func, moment_order
    )
