"""Fused per-lane coalescence and rainshaft-step physics on row arrays.

One physics body (`_make_coal_body`) evaluates, for every lane of a set of
``[1, B]`` moment rows (in the kernels of `ops.triton_coalescence`, B is a
program's block of columns),

    closure inversion → diagnostic moment recurrence → (per-column percentile
    thresholds for MovingThreshold) → Simpson/incomplete-gamma (or erf, or
    closed-form) autoconversion integrals (F2) → Q/R/S bilinear contraction

as straight-line elementwise `jax.numpy` code. Unlike the einsum path
(coalescence.py), which materializes the ``[B, D²]`` outer product and the
``[B, G, M]`` quadrature intermediates, every value here is a row (or a
``[G, B]`` quadrature tile). The Q/R/S contraction unrolls over the *static
nonzero* entries of the assembly weight tensors (typically 50-300 FMAs), not
the dense D².

Building blocks of the kernels:

- `_make_coal_body`: normalized moment rows → coalescence tendency rows;
- `make_local_rhs`: the level-local rainshaft RHS on physical rows (clip,
  normalize, closure, coalescence, empty-cell mask, sedimentation flux);
- `ssprk33_rows`: one SSPRK33 step of rows given the flux of the level
  above — the only term that couples levels.

Coverage — every configuration the XLA path accepts (reference parity:
src/Sources/Coalescence.jl:115-185, ParticleDistributions.jl:557-625,721-761):

- all four families (gamma, exponential, lognormal, monodisperse), both as
  thresholded and non-thresholded modes: gamma/exp F2 via the downward
  incomplete-gamma recurrence, lognormal F2 via exact Φ partial moments,
  monodisperse F2 in closed form;
- FixedThreshold (static per-mode quadrature grids precomputed host-side) and
  MovingThreshold (per-column percentile thresholds — exp −θlog(1−p), gamma
  θ·P⁻¹(k,p) by damped Newton, lognormal exp(μ+σz_p), mono θ — with the
  quadrature grid built from each column's threshold);
- both quadrature rules ("reference": the reference's masked log-grid
  Simpson, bit-identical to the XLA path; "gauss": Gauss–Legendre on the same
  log interval).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.special
import jax
import jax.numpy as jnp

from cloudy_tpu.spec import Family, get_moments_normalizing_factors
from cloudy_tpu.coalescence import CoalescenceData
from cloudy_tpu.distributions import GAMMA_K_RANGE
from cloudy_tpu.ops import special
from cloudy_tpu.ops.simpson import simpson_even_fast_weights


def _wb_nonzeros(data: CoalescenceData):
    """Static sparse view of the bilinear weights: [(out, i, j, coeff)]."""
    out = []
    n_out, D, _ = data.wb.shape
    for o in range(n_out):
        for i in range(D):
            for j in range(D):
                c = data.wb[o, i, j]
                if c != 0.0:
                    out.append((o, i, j, float(c)))
    return out


def _wf_nonzeros(data: CoalescenceData):
    out = []
    n_out, N, M, _ = data.wf.shape
    for o in range(n_out):
        for k in range(N):
            for p in range(M):
                for q in range(M):
                    c = data.wf[o, k, p, q]
                    if c != 0.0:
                        out.append((o, k, p, q, float(c)))
    return out


_FAMILIES = (
    Family.GAMMA,
    Family.EXPONENTIAL,
    Family.LOGNORMAL,
    Family.MONODISPERSE,
)


def pallas_supported(data: CoalescenceData) -> bool:
    """True for every configuration the XLA path accepts: all four families,
    fixed and moving thresholds, any mode order."""
    return all(fam in _FAMILIES for fam in data.spec.families)


def _static_grid(threshold: float, n_bins_per_log_unit: int = 15):
    """Reference log grid + Simpson weights for a static threshold
    (ParticleDistributions.jl:579-585 semantics, incl. the masked last
    point)."""
    t = float(threshold)
    x_lo = min(1e-5, 1e-5 * t)
    n_bins = int(np.floor(n_bins_per_log_unit * np.log10(t / x_lo)))
    x_min = np.log(x_lo)
    dx = (np.log(t) - x_min) / n_bins
    j = np.arange(1, n_bins + 2)
    x = np.exp(x_min + (j - 1) * dx)
    w = simpson_even_fast_weights(n_bins)
    mask = (j <= n_bins).astype(np.float64)
    return x, w * mask, dx


def _static_grid_gauss(threshold: float, n_nodes: int = 24):
    """Gauss–Legendre nodes in log-x on the same interval as the reference
    grid — ~3x fewer quadrature points at better-than-Simpson accuracy (the
    fast-path rule; the f64 reference-parity path keeps the Simpson grid).
    The log-space Jacobian is folded into the weights; `dx` returns 1."""
    t = float(threshold)
    x_lo = min(1e-5, 1e-5 * t)
    u, wu = np.polynomial.legendre.leggauss(n_nodes)
    a, b = np.log(x_lo), np.log(t)
    uu = a + 0.5 * (b - a) * (u + 1.0)
    x = np.exp(uu)
    # NB: the kernel's integrand rows are x^{p+k}·e^{-x/θ} — the log-space
    # Jacobian x is already folded into the power (as in the reference
    # Simpson formulation), so the weights carry only the interval scale.
    w = 0.5 * (b - a) * wu
    return x, w, 1.0


def _invert_rows(fam: Family, rows, eps, gamma_k_range=GAMMA_K_RANGE):
    """Closure inversion on [1, TB] rows (mirrors
    distributions._invert_* / reference ParticleDistributions.jl:456-541).
    `gamma_k_range` clips the gamma shape parameter; None bounds resolve to
    (eps, +inf) as in distributions._invert_gamma."""
    m0, m1 = rows[0], rows[1]
    valid = (m0 > eps) & (m1 > eps)
    m0s = jnp.where(valid, m0, 1.0)
    m1s = jnp.where(valid, m1, 1.0)
    if fam in (Family.EXPONENTIAL, Family.MONODISPERSE):
        n = jnp.where(valid, m0, 0.0)
        p1 = jnp.where(valid, m1s / m0s, 1.0)
        return n, p1, jnp.zeros_like(p1)
    m2 = rows[2]
    if fam == Family.GAMMA:
        k_lo = eps if gamma_k_range[0] is None else gamma_k_range[0]
        k_hi = np.inf if gamma_k_range[1] is None else gamma_k_range[1]
        m2s = jnp.where(valid, m2, 2.0)
        mean = m1s / m0s
        denom = m2s / m1s - mean
        denom = jnp.where(jnp.abs(denom) > 0, denom, eps)
        k = jnp.clip(mean / denom, k_lo, k_hi)
        theta = mean / k
        n = jnp.where(valid, m0, 0.0)
        return n, jnp.where(valid, theta, 1.0), jnp.where(valid, k, 1.0)
    if fam == Family.LOGNORMAL:
        valid = valid & (m2 > eps)
        m0s = jnp.where(valid, m0, 1.0)
        m1s = jnp.where(valid, m1, 1.0)
        m2s = jnp.where(valid, m2, 2.0)
        mu = jnp.log(m1s**2 / (m0s**1.5 * m2s**0.5))
        sig2 = jnp.log(jnp.maximum(m0s * m2s / m1s**2, 1.0))
        sigma = jnp.maximum(jnp.sqrt(sig2), eps)
        n = m1s / special.exp(mu + 0.5 * sigma**2)
        return (
            jnp.where(valid, n, 0.0),
            jnp.where(valid, mu, 1.0),
            jnp.where(valid, sigma, 1.0),
        )
    raise NotImplementedError(fam)


def _make_coal_body(
    data: CoalescenceData,
    gammainc_iters: Optional[int] = None,
    quad_rule: str = "reference",
    gauss_nodes: int = 24,
    thr_newton_iters: int = 32,
    thr_gammainc_iters: int = 128,
    f2_exact: Optional[bool] = None,
    gammainc_gl_nodes: Optional[int] = None,
):
    """Build the shared physics: ``body(mom_rows, grid_refs) -> (acc,
    params, mf)`` where `mom_rows` is the list of n_tot NORMALIZED ``[1, TB]``
    moment rows, `acc` the n_tot coalescence-tendency rows (None =
    structurally zero), `params` the per-mode closure parameters and `mf`
    the per-mode diagnostic moment rows. Returns ``(body, grid_inputs)``
    with `grid_inputs` the static ``[2, G]`` quadrature arrays (nodes,
    weights) the caller passes back as `grid_refs`, each padded to a
    power-of-two G with zero-weight copies of its last node (Triton tensor
    sizes are powers of two)."""
    if not pallas_supported(data):
        raise ValueError("configuration not supported by the fused body")
    spec = data.spec
    N, M = spec.n_modes, data.M
    n_tot = spec.n_tot
    iters = gammainc_iters or data.gammainc_iters
    if f2_exact is None:
        f2_exact = data.f2_exact
    if gammainc_gl_nodes is None:
        gammainc_gl_nodes = data.gammainc_gl_nodes

    def _gi_top(a, x, log_x=None, gln=None):
        # F2 top-order incomplete gamma: GL scheme when configured (proven
        # uniform accuracy, see special.gammainc_gl), else series/CF.
        # ``gln`` (= lgamma(a)) lets the exact-F2 path reuse its delta
        # chain's Lanczos evaluation instead of paying a second one.
        if gammainc_gl_nodes:
            return special.gammainc_gl(
                a, x, n_nodes=gammainc_gl_nodes, gln=gln
            )
        return special.gammainc_impl(a, x, n_iters=iters, log_x=log_x)

    wb_nz = _wb_nonzeros(data)
    wf_nz = _wf_nonzeros(data)

    # Which modes carry an F2 quadrature (thresholded, non-last, non-mono;
    # mono F2 is closed-form and needs no grid). MovingThreshold: every
    # non-last mode is thresholded (percentiles; reference Coalescence.jl:
    # 152-185). FixedThreshold: finite thresholds only.
    def _thresholded(i):
        if i >= N - 1:
            return False
        if data.moving:
            return True
        return bool(np.isfinite(data.thresholds[i]))

    thresholded_modes = [i for i in range(N) if _thresholded(i)]
    # modes needing a quadrature grid: mono F2 is closed-form, and with
    # f2_exact gamma/exp F2 is too — only lognormal keeps its grid then
    _gridless = (
        (Family.MONODISPERSE, Family.GAMMA, Family.EXPONENTIAL)
        if f2_exact
        else (Family.MONODISPERSE,)
    )
    grid_modes = [
        i for i in thresholded_modes if spec.families[i] not in _gridless
    ]
    # lognormal modes on the density-recentered window rule (the
    # proven-bound fast path, coalescence._msh_matrix_lognormal_window):
    # no static grid — one shared [2, G] base-node input, the per-column
    # window built per column from (μ, σ, T)
    ln_window = data.lognorm_gl_nodes
    window_modes = (
        [i for i in grid_modes if spec.families[i] == Family.LOGNORMAL]
        if ln_window
        else []
    )
    grid_modes = [i for i in grid_modes if i not in window_modes]

    # static quadrature inputs — passed back to `body` as arrays (a kernel
    # takes them as inputs: Pallas forbids captured array constants).
    #
    # FixedThreshold: one [2, G] grid per grid mode; row 0 = x nodes, row 1 =
    #   weights (masked Simpson or GL).
    # MovingThreshold + gauss: ONE shared [2, gauss_nodes] input of GL base
    #   nodes/weights on [-1, 1]; the per-column grid is built in the body.
    # MovingThreshold + reference: no input (iota-built masked Simpson grid
    #   of data.n_points_max points, matching distributions.threshold_log_grid).
    grids = {}
    grid_inputs = []
    if not data.moving:
        for i in grid_modes:
            if quad_rule == "gauss":
                x_np, w_np, dx = _static_grid_gauss(data.thresholds[i], gauss_nodes)
            else:
                x_np, w_np, dx = _static_grid(data.thresholds[i])
            grids[i] = dx
            grid_inputs.append(np.stack([x_np, w_np]))
    elif quad_rule == "gauss" and grid_modes:
        u_np, wu_np = np.polynomial.legendre.leggauss(gauss_nodes)
        grid_inputs.append(np.stack([u_np, wu_np]))
    window_slot = None
    if window_modes:
        v_np, wv_np = np.polynomial.legendre.leggauss(ln_window)
        window_slot = len(grid_inputs)
        grid_inputs.append(np.stack([v_np, wv_np]))
    grid_inputs = [_pad_pow2(g) for g in grid_inputs]

    # static per-mode percentile constants for the moving path
    if data.moving:
        percentiles = [float(p) for p in data.thresholds]
        z_ndtri = [float(scipy.special.ndtri(p)) for p in percentiles]

    def body(mom_rows, grid_refs):
        dtype = mom_rows[0].dtype
        eps = jnp.finfo(dtype).eps
        tiny = jnp.finfo(dtype).tiny
        TB = mom_rows[0].shape[1]

        # ---- closure inversion per mode (rows are [1, TB] tiles) ----------
        params = []  # (n, p1, p2) per mode — same layout as distributions
        for i, fam in enumerate(spec.families):
            o = spec.offsets[i]
            rows = [mom_rows[o + j] for j in range(spec.nprogmoms[i])]
            params.append(_invert_rows(fam, rows, eps))

        # ---- diagnostic moment recurrence: Mf[i][p], p = 0..M-1 -----------
        # (mirrors distributions._integer_moments_one_mode term-for-term)
        mf = []
        for i, fam in enumerate(spec.families):
            n, p1, p2 = params[i]
            rows = [n]
            m = n
            for o in range(M - 1):
                if fam == Family.EXPONENTIAL:
                    m = m * p1 * (o + 1.0)
                elif fam == Family.GAMMA:
                    m = m * p1 * (p2 + o)
                elif fam == Family.MONODISPERSE:
                    m = m * p1
                elif fam == Family.LOGNORMAL:
                    m = m * special.exp(p1 + (2.0 * o + 1.0) * 0.5 * p2**2)
                rows.append(m)
            mf.append(rows)

        # ---- per-column thresholds (MovingThreshold only) ------------------
        # mirrors distributions.compute_thresholds
        thr_rows = {}
        if data.moving:
            for i in thresholded_modes:
                fam = spec.families[i]
                n, p1, p2 = params[i]
                p = percentiles[i]
                if fam == Family.EXPONENTIAL:
                    thr = p1 * (-float(np.log1p(-p)))
                elif fam == Family.GAMMA:
                    if gammainc_gl_nodes:
                        # proven-bound fast inverse: WH +
                        # small-x start, 3 Halley iterations, shift-4 GL
                        # inner — < 2e-5 rel f64 / < 2e-4 f32 worst case
                        # over the reachable (k, p) domain
                        # (tests/test_special.py), ~3x cheaper than the
                        # 8×12 series/CF Newton ablation setting
                        thr = p1 * special.gammaincinv_gl_impl(
                            p2,
                            jnp.full_like(p1, p),
                            n_iter=3,
                            n_nodes=gammainc_gl_nodes,
                        )
                    else:
                        # reference-parity inverse: a rolled Newton loop
                        thr = p1 * special.gammaincinv_impl(
                            p2,
                            jnp.full_like(p1, p),
                            n_newton=thr_newton_iters,
                            n_iters=thr_gammainc_iters,
                        )
                elif fam == Family.LOGNORMAL:
                    thr = special.exp(p1 + p2 * z_ndtri[i])
                elif fam == Family.MONODISPERSE:
                    thr = p1
                thr_rows[i] = jnp.maximum(thr, 1e-18)

        # ---- per-column quadrature grid for moving thresholds -------------
        def _moving_grid(slot, T):
            """(x, w·mask, dx) from a per-column threshold row [1, TB];
            replicates distributions.threshold_log_grid +
            simpson_even_fast_weights_dynamic for the reference rule, or the
            GL log-interval rule for the fast path."""
            if quad_rule == "gauss":
                G = grid_refs[slot].shape[1]
                u = grid_refs[slot][0, :].reshape(G, 1)
                wu = grid_refs[slot][1, :].reshape(G, 1)
                x_lo = 1e-5 * jnp.minimum(T, 1.0)
                a, b = jnp.log(x_lo), jnp.log(T)
                x = special.exp(a + 0.5 * (b - a) * (u + 1.0))  # [G, TB]
                w = 0.5 * (b - a) * wu
                return x, w, 1.0, G
            G = data.n_points_max
            j = (
                jax.lax.broadcasted_iota(jnp.int32, (G, 1), 0).astype(dtype)
                + 1.0
            )  # 1-based, [G, 1]
            x_lo = jnp.minimum(jnp.asarray(1e-5, dtype), 1e-5 * T)
            ratio = jnp.log10(T / x_lo)
            nb = jnp.minimum(jnp.floor(15.0 * ratio), float(G - 1))  # [1, TB]
            x_min = jnp.log(x_lo)
            dx = (jnp.log(T) - x_min) / nb
            x = special.exp(x_min + (j - 1.0) * dx)  # [G, TB]
            interior = ((j >= 5.0) & (j <= nb - 3.0)).astype(dtype)
            w = interior
            for jj, c in ((1.0, 17.0), (2.0, 59.0), (3.0, 43.0), (4.0, 49.0)):
                w = w + jnp.where(j == jj, c / 48.0, 0.0).astype(dtype)
            e = nb + 1.0
            for off, c in ((0.0, 17.0), (1.0, 59.0), (2.0, 43.0), (3.0, 49.0)):
                w = w + jnp.where(j == e - off, c / 48.0, 0.0).astype(dtype)
            mask = (j <= nb).astype(dtype)
            return x, w * mask, dx, G

        # ---- F2 matrices for thresholded modes -----------------------------
        def _f2_gamma(i, x, w, dx, T, n, theta, k):
            """Gamma/exponential F2 via the downward incomplete-gamma
            recurrence (see coalescence._msh_matrix_gamma)."""
            logx = jnp.log(x)
            inv_theta = 1.0 / theta  # [1, TB]
            rem = jnp.maximum(T - x, 0.0) * inv_theta  # [G, TB]
            log_rem = jnp.log(jnp.maximum(rem, tiny))

            # Poisson terms delta(k+q), q = 0..M-2, upward multiplicative
            delta = special.exp(k * log_rem - rem - special.lgamma(k + 1.0))
            delta = jnp.where(rem > 0.0, delta, 0.0)
            deltas = [delta]
            for q in range(1, M - 1):
                deltas.append(deltas[-1] * rem / (k + q))
            # top order directly, then the forward-stable downward recurrence
            gi = _gi_top(k + (M - 1.0), rem, log_x=log_rem)
            gis = [gi]
            for q in range(M - 2, -1, -1):
                gi = jnp.clip(gi + deltas[q], 0.0, 1.0)
                gis.append(gi)
            gis.reverse()

            # integrand rows Y_p = w · x^{p+k} e^{-x/θ}
            base = special.exp(k * logx - x * inv_theta) * w  # [G, TB]
            lgk = special.lgamma(k)
            logth = jnp.log(theta)
            # per-q prefactor n² θ^{q−k} Γ(q+k)/Γ(k)², advanced
            # multiplicatively from q = 0 (pref_{q+1} = pref_q · θ (k+q))
            prefs = [(n * n) * special.exp(-k * logth - lgk)]
            for q in range(1, M):
                prefs.append(prefs[-1] * theta * (k + q - 1.0))

            f2i = {}
            ypow = base
            for p in range(M):
                if p > 0:
                    ypow = ypow * x
                for q in range(p, M):
                    if p >= data.n_2d_ints[i] or q >= data.n_2d_ints[i]:
                        continue
                    raw = jnp.sum(ypow * gis[q], axis=0, keepdims=True) * dx
                    f2i[(p, q)] = raw * prefs[q]
            return f2i

        def _f2_gamma_exact(i, T, n, theta, k):
            """Exact gamma/exponential F2 (see
            coalescence._msh_matrix_gamma_exact): F2(p,q) = M_p·M_q·
            P(2k+p+q, T/θ) — one row-shaped [1, TB] incomplete gamma at the
            top order plus the downward Poisson recurrence; no grid."""
            x = jnp.minimum(T / theta, 1e6)
            log_x = jnp.log(jnp.maximum(x, tiny))
            a0 = 2.0 * k
            # fast tier: 1-divide Stirling-shift lgamma (same switch as
            # the XLA twin _msh_matrix_gamma_exact — parity preserved)
            lga01 = (
                special.lgamma_stirling(a0 + 1.0)
                if gammainc_gl_nodes
                else special.lgamma(a0 + 1.0)
            )
            d = special.exp(a0 * log_x - x - lga01)
            d = jnp.where(x > 0.0, d, 0.0)
            ds = [d]
            prod = None
            for j in range(1, 2 * M - 2):
                ds.append(ds[-1] * x / (a0 + j))
                prod = (a0 + j) if prod is None else prod * (a0 + j)
            # lgamma(a0 + 2M−2) = lgamma(a0+1) + log((a0+1)…(a0+2M−3)):
            # one log instead of a second Lanczos chain in the GL scheme
            gi = _gi_top(
                a0 + (2.0 * M - 2.0),
                x,
                log_x=log_x,
                gln=None if prod is None else lga01 + jnp.log(prod),
            )
            gis = [gi]
            for j in range(2 * M - 3, -1, -1):
                gi = jnp.clip(gi + ds[j], 0.0, 1.0)
                gis.append(gi)
            gis.reverse()  # gis[s] = P(2k + s, T/θ)

            mm_rows = mf[i]
            f2i = {}
            for p in range(M):
                for q in range(p, M):
                    if p >= data.n_2d_ints[i] or q >= data.n_2d_ints[i]:
                        continue
                    f2i[(p, q)] = mm_rows[p] * mm_rows[q] * gis[p + q]
            return f2i

        def _f2_lognormal(i, x, w, dx, T, n, mu, sig):
            """Lognormal F2 via exact Φ partial moments (mirrors
            coalescence._msh_matrix_lognormal; erf through gammainc, as
            there)."""
            logx = jnp.log(jnp.maximum(x, tiny))
            fx = special.exp(-((logx - mu) ** 2) / (2.0 * sig**2)) / (
                x * sig * float(np.sqrt(2.0 * np.pi))
            )
            rem = jnp.maximum(T - x, 0.0)
            logrem = jnp.log(jnp.maximum(rem, tiny))

            pms = []
            for q in range(M):
                z = (logrem - mu - q * sig**2) / (sig * float(np.sqrt(2.0)))
                # gammainc_gl_nodes > 0 selects the proven-bound fast
                # special-function set (rational erf, 1.5e-7; matches the
                # XLA path's erf_fast switch in _msh_matrix_lognormal)
                erf_z = (
                    special.erf_approx(z)
                    if gammainc_gl_nodes
                    else special.erf_impl(z, n_iters=iters)
                )
                pm = special.exp(q * mu + 0.5 * q**2 * sig**2) * 0.5 * (
                    1.0 + erf_z
                )
                pms.append(jnp.where(rem > 0.0, pm, 0.0))

            n2 = n * n
            f2i = {}
            ypow = x * fx * w
            for p in range(M):
                if p > 0:
                    ypow = ypow * x
                for q in range(p, M):
                    if p >= data.n_2d_ints[i] or q >= data.n_2d_ints[i]:
                        continue
                    raw = jnp.sum(ypow * pms[q], axis=0, keepdims=True) * dx
                    f2i[(p, q)] = raw * n2
            return f2i

        def _f2_lognormal_window(i, T, n, mu, sig):
            """Density-recentered GL window rule on row tiles (mirrors
            coalescence._msh_matrix_lognormal_window term for term — the
            proven-bound lognormal fast path, 4.0e-4 worst case at 16
            nodes)."""
            from cloudy_tpu.coalescence import LOGNORM_WINDOW_SIGMA

            G = grid_refs[window_slot].shape[1]
            vg = grid_refs[window_slot][0, :].reshape(G, 1)
            wg = grid_refs[window_slot][1, :].reshape(G, 1)
            W = LOGNORM_WINDOW_SIGMA
            logT = jnp.log(jnp.maximum(T, tiny))
            lo = mu - W * sig
            hi = jnp.minimum(logT, mu + M * sig**2 + W * sig)
            half = jnp.maximum(hi - lo, 0.0) * 0.5
            center = lo + half
            u = center + half * vg  # [G, TB]
            x = special.exp(u)
            g0 = (
                half
                * wg
                * special.exp(-((u - mu) ** 2) / (2.0 * sig**2))
                / (sig * float(np.sqrt(2.0 * np.pi)))
            )
            rem = jnp.maximum(T - x, 0.0)
            logrem = jnp.log(jnp.maximum(rem, tiny))
            pms = []
            for q in range(M):
                z = (logrem - mu - q * sig**2) / (sig * float(np.sqrt(2.0)))
                pm = special.exp(q * mu + 0.5 * q**2 * sig**2) * 0.5 * (
                    1.0 + special.erf_approx(z)
                )
                pms.append(jnp.where(rem > 0.0, pm, 0.0))
            n2 = n * n
            f2i = {}
            ypow = g0
            for p in range(M):
                if p > 0:
                    ypow = ypow * x
                for q in range(p, M):
                    if p >= data.n_2d_ints[i] or q >= data.n_2d_ints[i]:
                        continue
                    f2i[(p, q)] = (
                        jnp.sum(ypow * pms[q], axis=0, keepdims=True) * n2
                    )
            return f2i

        f2 = {}
        slot = 0  # grid-input slot (fixed: one per grid mode; moving+gauss: shared 0)
        for i in thresholded_modes:
            fam = spec.families[i]
            n, p1, p2 = params[i]
            mm_rows = mf[i]
            if data.moving:
                T = thr_rows[i]
            else:
                T = jnp.asarray(float(data.thresholds[i]), dtype)

            if fam == Family.MONODISPERSE:
                # closed form (reference ParticleDistributions.jl:557-564):
                # msh(p,q) = n²θ^{p+q} when θ < T/2 else 0 — and n²θ^{p+q} is
                # exactly M_p·M_q, so min(mm, msh) = where(θ < T/2, mm, 0).
                below = p1 < T / 2.0
                f2i = {}
                for p in range(M):
                    for q in range(p, M):
                        if p >= data.n_2d_ints[i] or q >= data.n_2d_ints[i]:
                            continue
                        f2i[(p, q)] = jnp.where(
                            below, mm_rows[p] * mm_rows[q], 0.0
                        )
            elif f2_exact and fam in (Family.GAMMA, Family.EXPONENTIAL):
                kk = p2 if fam == Family.GAMMA else jnp.ones_like(p1)
                f2i = _f2_gamma_exact(i, T, n, p1, kk)
            elif i in window_modes:
                f2i = _f2_lognormal_window(i, T, n, p1, p2)
            else:
                if data.moving:
                    x, w, dx, G = _moving_grid(0 if quad_rule == "gauss" else None, T)
                else:
                    G, dx = grid_refs[slot].shape[1], grids[i]
                    x = grid_refs[slot][0, :].reshape(G, 1)
                    w = grid_refs[slot][1, :].reshape(G, 1)
                    slot += 1
                if fam in (Family.GAMMA, Family.EXPONENTIAL):
                    kk = p2 if fam == Family.GAMMA else jnp.ones_like(p1)
                    f2i = _f2_gamma(i, x, w, dx, T, n, p1, kk)
                else:  # LOGNORMAL
                    f2i = _f2_lognormal(i, x, w, dx, T, n, p1, p2)

            # clamp against M_p·M_q and apply the reference zero-structure
            out = {}
            for (p, q), msh in f2i.items():
                mm = mm_rows[p] * mm_rows[q]
                val = jnp.minimum(mm, msh)
                val = jnp.where(mm < eps, 0.0, val)
                out[(p, q)] = val
                out[(q, p)] = val
            f2[i] = out

        def f2_lookup(i, p, q):
            # non-thresholded / last modes use the mm fallback with the
            # reference's zero-structure (Coalescence.jl:207-240)
            if i in f2:
                return f2[i].get((p, q))
            if p >= data.n_2d_ints[i] or q >= data.n_2d_ints[i]:
                return None
            mm = mf[i][p] * mf[i][q]
            return jnp.where(mm < jnp.finfo(mm.dtype).eps, 0.0, mm)

        # ---- Q/R/S contraction: unrolled sparse FMAs ---------------------
        acc = [None] * n_tot
        flat = [row for rows in mf for row in rows]  # index i*M + p
        for (o, i, j, c) in wb_nz:
            term = c * flat[i] * flat[j]
            acc[o] = term if acc[o] is None else acc[o] + term
        for (o, k_, p, q, c) in wf_nz:
            v = f2_lookup(k_, p, q)
            if v is None:
                continue
            term = c * v
            acc[o] = term if acc[o] is None else acc[o] + term
        return acc, params, mf

    return body, grid_inputs


def _pad_pow2(g):
    """``[2, G]`` (nodes, weights) → ``[2, 2^⌈log2 G⌉]``: extra columns
    repeat the last node (finite integrand) with zero weight."""
    extra = (1 << (g.shape[1] - 1).bit_length()) - g.shape[1]
    g = np.pad(g, ((0, 0), (0, extra)), mode="edge")
    g[1, g.shape[1] - extra:] = 0.0
    return g


def _sedi_flux_rows(spec, params, vel_n, dtype, fast_ratio: bool = False):
    """Physical-velocity sedimentation flux ladder on row tiles: returns the
    n_tot NORMALIZED-unit flux rows ``-Σ_k c_k·M_{m+e_k}`` per (mode i,
    moment m), from the closure params — the fused in-kernel form of
    `sedimentation.get_sedimentation_flux` (reference Sedimentation.jl:22-37).
    Fractional moments by the per-mode recurrence
    ``M_{m+1+e} = M_{m+e}·θ·(k+m+e)`` off one lgamma-pair base (gamma), a
    static Γ(1+e) base (exponential), or the direct closed form
    (lognormal/monodisperse). ``fast_ratio`` (set with the proven-bound
    fast special-function tier, gammainc_gl_nodes > 0) replaces the gamma
    base's Lanczos-lgamma pair with `special.gamma_ratio` — 2 logs + 1 exp
    instead of ~23 transcendental-class ops, < 5e-7 relative
    (tests/test_special.py); it was the dominant unaccounted term of the
    whole step's cost."""
    tiny = jnp.finfo(dtype).tiny
    out = [None] * spec.n_tot
    for i, fam in enumerate(spec.families):
        n, p1, p2 = params[i]
        logp1 = jnp.log(jnp.maximum(p1, tiny))
        flux = [None] * spec.nprogmoms[i]
        for (c, e) in vel_n:
            # fractional-moment ladder M_{m+e}, m = 0..nprog-1
            if fam == Family.GAMMA:
                if fast_ratio:
                    t = n * special.exp(e * logp1) * special.gamma_ratio(
                        p2, e
                    )
                else:
                    t = n * special.exp(
                        e * logp1 + special.lgamma(p2 + e) - special.lgamma(p2)
                    )
            elif fam == Family.EXPONENTIAL:
                t = n * (math.gamma(1.0 + e)) * special.exp(e * logp1)
            elif fam == Family.MONODISPERSE:
                t = n * special.exp(e * logp1)
            for m in range(spec.nprogmoms[i]):
                q = m + e
                if fam == Family.LOGNORMAL:
                    t = n * special.exp(q * p1 + 0.5 * q * q * p2 * p2)
                elif m > 0:
                    if fam == Family.GAMMA:
                        t = t * p1 * (p2 + (m - 1.0) + e)
                    elif fam == Family.EXPONENTIAL:
                        t = t * p1 * (m + e)
                    elif fam == Family.MONODISPERSE:
                        t = t * p1
                term = c * t
                flux[m] = term if flux[m] is None else flux[m] + term
        for m in range(spec.nprogmoms[i]):
            out[spec.offsets[i] + m] = -flux[m]
    return out


def make_local_rhs(
    data: CoalescenceData,
    vel: Sequence[Tuple[float, float]],
    norms: Tuple[float, float],
    **coal_kwargs,
):
    """The level-local part of the rainshaft RHS on physical rows.

    Returns ``(local, grid_inputs)``: ``local(y_rows, grids, s_row) ->
    (coal_rows, flux_rows)`` gives, per level, the PHYSICAL coalescence
    tendency (negative clipping, normalization, closure, F2, Q/R/S,
    empty-cell mask, denormalization — `models.rainshaft.make_rainshaft_rhs`'s
    per-level semantics, reference rainshaft_helpers.jl:53-77), multiplied
    by the optional per-lane row `s_row`, and the PHYSICAL sedimentation
    moment fluxes ``−Σ_k c_k·M_{m+e_k}`` (reference Sedimentation.jl:22-37)
    for the physical power-law velocity `vel`."""
    spec = data.spec
    n_tot = spec.n_tot
    mom_norms = [
        float(v) for v in get_moments_normalizing_factors(spec.nprogmoms, norms)
    ]
    vel_n = tuple((float(c) * norms[1] ** float(e), float(e)) for (c, e) in vel)
    gl_nodes = coal_kwargs.get("gammainc_gl_nodes")
    if gl_nodes is None:
        gl_nodes = data.gammainc_gl_nodes
    body, grid_inputs = _make_coal_body(data, **coal_kwargs)

    def local(y_rows, grids, s_row=None):
        dtype = y_rows[0].dtype
        eps = jnp.finfo(dtype).eps
        mom_rows = []
        empty = None
        for o in range(n_tot):
            r = jnp.maximum(y_rows[o], 0.0) * (1.0 / mom_norms[o])
            mom_rows.append(r)
            lo = r < eps
            empty = lo if empty is None else (empty & lo)
        acc, params, _ = body(mom_rows, grids)
        flux_rows = _sedi_flux_rows(
            spec, params, vel_n, dtype, fast_ratio=bool(gl_nodes)
        )
        coal, flux = [], []
        for o in range(n_tot):
            c = acc[o] if acc[o] is not None else jnp.zeros_like(y_rows[o])
            c = jnp.where(empty, 0.0, c) * mom_norms[o]
            coal.append(c if s_row is None else c * s_row)
            flux.append(flux_rows[o] * mom_norms[o])
        return coal, flux

    return local, grid_inputs


def ssprk33_rows(y, local, upstream, dt: float, inv_dz: float):
    """One SSPRK33 step of the rainshaft on rows (reference
    rainshaft_helpers.jl:45-89 with the Shu–Osher stages of
    `stepper.ssprk33_step`).

    `local(rows) -> (coal_rows, flux_rows)` is the level-local RHS and
    ``upstream[stage]`` holds the flux rows of the level ABOVE (zero above
    the column top) for RK stage 0, 1 or 2: the upwind divergence
    ``−(F[i+1] − F[i])/dz`` is the only term that couples levels. Returns
    ``(y_next_rows, (F(y), F(u1), F(u2)))`` so a level loop can carry the
    three stage fluxes to the level below."""
    n = len(y)

    def rhs(stage, rows):
        coal, flux = local(rows)
        up = upstream[stage]
        return [coal[o] - (up[o] - flux[o]) * inv_dz for o in range(n)], flux

    f0, fl0 = rhs(0, y)
    u1 = [y[o] + dt * f0[o] for o in range(n)]
    f1, fl1 = rhs(1, u1)
    u2 = [0.75 * y[o] + 0.25 * (u1[o] + dt * f1[o]) for o in range(n)]
    f2, fl2 = rhs(2, u2)
    out = [y[o] / 3.0 + (2.0 / 3.0) * (u2[o] + dt * f2[o]) for o in range(n)]
    return out, (fl0, fl1, fl2)
