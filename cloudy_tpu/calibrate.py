"""Parameter calibration: batched Ensemble Kalman Inversion + gradient fits.

The reference (CliMA/Cloudy.jl) has no calibration code of its own — in the
CliMA stack, Cloudy's kernel/closure parameters are calibrated externally by
EnsembleKalmanProcesses.jl, which treats the model as a black box precisely
because the Julia implementation exposes no gradients. This module is the
BUILD-NEW equivalent designed for this framework's two structural advantages:

1. **The forward model is a batched JAX program.** An EKI ensemble of J
   parameter vectors is evaluated as ONE `jax.vmap`-batched forward pass —
   J trajectories integrate in a single `lax.scan` on the device, instead
   of J independent model runs
   round-tripping through a host-side calibration driver.
2. **The forward model is differentiable** (tests/test_autodiff.py), so
   gradient-based fitting (`fit_gradient`, optax) is available as well —
   a capability the reference ecosystem's black-box EKP workflow lacks.

Both drivers are pure functions of (key, data): the whole calibration loop —
ensemble propagation, Kalman update, misfit history — is one jitted
`lax.scan`, with no host round-trips between iterations.

EKI update (perturbed-observation form, Iglesias/Law/Stuart 2013):
    θ_{n+1}^{(j)} = θ_n^{(j)} + C_θg (C_gg + Γ)^{-1} (y + η^{(j)} − g^{(j)})
with C_θg, C_gg the ensemble cross-/auto-covariances of parameters and
forward evaluations, Γ the observation-noise covariance, η ~ N(0, Γ).

UKI (`run_uki`) is the deterministic sibling (Huang/Schneider/Stuart 2022,
the EKP.jl `Unscented` process): it propagates an explicit Gaussian (m, C)
through 2P symmetric sigma points instead of a random ensemble — no
perturbed observations, reproducible without a key, and C itself converges
to an uncertainty estimate (exactly (AᵀΓ⁻¹A)⁻¹ for linear G; pinned in
tests/test_calibrate.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

#: f32 matmuls at full precision: a GPU may otherwise run them in TF32
_HI = jax.lax.Precision.HIGHEST


class EKIResult(NamedTuple):
    """`theta`: final ensemble [J, P]. `theta_history`: [n_iters+1, J, P].
    `misfit_history`: [n_iters+1] mean data misfit ‖Γ^{-1/2}(y − g)‖²/D
    (whitened mean-square residual; ~1 at the noise floor)."""

    theta: jnp.ndarray
    theta_history: jnp.ndarray
    misfit_history: jnp.ndarray


def _as_cov(noise_cov, d, dtype):
    """Accept a scalar, a diagonal [D], or a full [D, D] covariance."""
    g = jnp.asarray(noise_cov, dtype)
    if g.ndim == 0:
        return g * jnp.eye(d, dtype=dtype)
    if g.ndim == 1:
        return jnp.diag(g)
    return g


def eki_step(theta, g, y, noise_cov, key):
    """One perturbed-observation EKI update.

    theta: [J, P] parameter ensemble; g: [J, D] forward evaluations G(θ);
    y: [D] observations; noise_cov: scalar | [D] | [D, D]. Returns the
    updated [J, P] ensemble. All covariance work is two small matmuls and
    one Cholesky solve of a [D, D] system, J-batched."""
    J, _ = theta.shape
    d = y.shape[0]
    gamma = _as_cov(noise_cov, d, theta.dtype)

    th_a = theta - jnp.mean(theta, axis=0, keepdims=True)  # [J, P]
    g_a = g - jnp.mean(g, axis=0, keepdims=True)  # [J, D]
    c_thg = jnp.matmul(th_a.T, g_a, precision=_HI) / (J - 1)  # [P, D]
    c_gg = jnp.matmul(g_a.T, g_a, precision=_HI) / (J - 1)  # [D, D]

    eta = jax.random.multivariate_normal(
        key, jnp.zeros(d, theta.dtype), gamma, (J,), method="svd"
    )
    resid = y[None, :] + eta - g  # [J, D]
    # solve (C_gg + Γ) X = residᵀ ; symmetric PSD → Cholesky
    sol = jax.scipy.linalg.solve(
        c_gg + gamma, resid.T, assume_a="pos"
    )  # [D, J]
    return theta + jnp.matmul(c_thg, sol, precision=_HI).T


def run_eki(
    forward: Callable,
    theta0,
    y,
    noise_cov,
    n_iters: int,
    key,
    transform: Optional[Callable] = None,
) -> EKIResult:
    """Run `n_iters` EKI iterations as ONE jitted `lax.scan`.

    ``forward(theta_single [P]) -> [D]`` is the per-member forward map; it is
    `jax.vmap`-batched over the ensemble here (do NOT pre-vmap). ``transform``
    optionally maps the unconstrained θ the EKI updates into the model's
    native parameter space inside `forward` composition (e.g. `jnp.exp` for
    positivity — the standard EKP trick); misfits are reported in data space
    either way."""
    theta0 = jnp.atleast_2d(jnp.asarray(theta0))
    y = jnp.asarray(theta0.dtype.type(1) * jnp.asarray(y))
    d = y.shape[0]
    gamma = _as_cov(noise_cov, d, theta0.dtype)
    # whitening by Γ^{-1/2} for the misfit diagnostic
    gamma_chol = jnp.linalg.cholesky(gamma)

    fwd1 = forward if transform is None else (lambda t: forward(transform(t)))
    fwd = jax.vmap(fwd1)

    def misfit(g):
        r = jax.scipy.linalg.solve_triangular(
            gamma_chol, (y[None, :] - g).T, lower=True
        )
        return jnp.mean(r**2)

    def body(carry, k):
        theta = carry
        g = fwd(theta)
        theta_next = eki_step(theta, g, y, gamma, k)
        return theta_next, (theta, misfit(g))

    keys = jax.random.split(key, n_iters)
    theta_f, (th_hist, mf_hist) = jax.lax.scan(body, theta0, keys)
    g_f = fwd(theta_f)
    theta_history = jnp.concatenate([th_hist, theta_f[None]], axis=0)
    misfit_history = jnp.concatenate([mf_hist, misfit(g_f)[None]], axis=0)
    return EKIResult(theta_f, theta_history, misfit_history)


def ensemble_init(key, prior_mean, prior_std, n_ens: int):
    """Draw an [J, P] initial ensemble from an independent-normal prior."""
    mean = jnp.atleast_1d(jnp.asarray(prior_mean))
    std = jnp.broadcast_to(jnp.asarray(prior_std, mean.dtype), mean.shape)
    return mean[None, :] + std[None, :] * jax.random.normal(
        key, (n_ens, mean.shape[0]), mean.dtype
    )


def run_sparse_eki(
    forward: Callable,
    theta0,
    y,
    noise_cov,
    n_iters: int,
    key,
    lambda_l1: float = 1e-2,
    prune_below: float = 0.0,
    sparse_idx=None,
    polish_iters: Optional[int] = None,
    transform: Optional[Callable] = None,
) -> EKIResult:
    """Sparsity-promoting EKI (the EKP.jl `SparseInversion` capability),
    in two phases:

    1. **Support identification** — `n_iters` EKI updates, each followed by
       a proximal l1 step (soft threshold ``θ ← sign(θ)·max(|θ| − λ, 0)``
       plus a hard prune of entries below ``prune_below``) on the
       coordinates in ``sparse_idx`` (default: all). The prox operator
       replaces the reference ecosystem's per-member constrained QP with
       the standard ISTA step — same l1-regularized fixed points, one
       fused batched op on device.
    2. **Debiasing polish** — repeated soft thresholding biases surviving
       coefficients low (each prox subtracts up to λ after the Kalman
       correction has shrunk), so the support is then frozen (coordinates
       whose ensemble mean was thresholded to exactly 0 stay 0) and
       ``polish_iters`` (default `n_iters`) PLAIN EKI updates refit the
       active coefficients without shrinkage.

    Use when the parameter vector is over-complete (e.g. all kernel-tensor
    coefficients via `coalescence.make_kernel_diff_coal_fn`) and the
    physics is expected to be explained by few terms. Returns an
    `EKIResult` (histories cover both phases); exact-zero recovery and
    debiasing are pinned in tests/test_calibrate.py."""
    theta0 = jnp.atleast_2d(jnp.asarray(theta0))
    p = theta0.shape[1]
    if sparse_idx is None:
        mask = jnp.ones(p, dtype=theta0.dtype)
    else:
        mask = jnp.zeros(p, dtype=theta0.dtype).at[jnp.asarray(sparse_idx)].set(1.0)
    y = jnp.asarray(y, theta0.dtype)
    d = y.shape[0]
    gamma = _as_cov(noise_cov, d, theta0.dtype)
    gamma_chol = jnp.linalg.cholesky(gamma)

    fwd1 = forward if transform is None else (lambda t: forward(transform(t)))
    fwd = jax.vmap(fwd1)

    def misfit(g):
        r = jax.scipy.linalg.solve_triangular(
            gamma_chol, (y[None, :] - g).T, lower=True
        )
        return jnp.mean(r**2)

    def prox(theta):
        soft = jnp.sign(theta) * jnp.maximum(jnp.abs(theta) - lambda_l1, 0.0)
        soft = jnp.where(jnp.abs(soft) < prune_below, 0.0, soft)
        return mask * soft + (1.0 - mask) * theta

    def body(theta, k):
        g = fwd(theta)
        theta_next = prox(eki_step(theta, g, y, gamma, k))
        return theta_next, (theta, misfit(g))

    k_prox, k_polish = jax.random.split(key)
    keys = jax.random.split(k_prox, n_iters)
    theta_f, (th_hist, mf_hist) = jax.lax.scan(body, theta0, keys)

    # phase 2: freeze the identified support, refit without shrinkage
    n_polish = n_iters if polish_iters is None else polish_iters
    support = jnp.where(
        mask > 0,
        (jnp.abs(jnp.mean(theta_f, axis=0)) > 0.0).astype(theta0.dtype),
        1.0,
    )

    def body_polish(theta, k):
        g = fwd(theta)
        theta_next = support[None, :] * eki_step(theta, g, y, gamma, k)
        return theta_next, (theta, misfit(g))

    theta_f = support[None, :] * theta_f
    if n_polish > 0:
        # phase 1 both collapses the ensemble (standard EKI) and biases the
        # survivors low (prox shrinkage) — re-inflate around the pruned mean
        # with spread ~ the worst-case shrinkage bias so the polish phase
        # has the covariance it needs to undo it
        k_inflate, k_polish = jax.random.split(k_polish)
        spread = lambda_l1 * n_iters + prune_below
        theta_f = support[None, :] * (
            jnp.mean(theta_f, axis=0)[None, :]
            + spread * jax.random.normal(k_inflate, theta_f.shape, theta0.dtype)
        )
        keys2 = jax.random.split(k_polish, n_polish)
        theta_f, (th_hist2, mf_hist2) = jax.lax.scan(
            body_polish, theta_f, keys2
        )
        th_hist = jnp.concatenate([th_hist, th_hist2], axis=0)
        mf_hist = jnp.concatenate([mf_hist, mf_hist2], axis=0)

    g_f = fwd(theta_f)
    return EKIResult(
        theta_f,
        jnp.concatenate([th_hist, theta_f[None]], axis=0),
        jnp.concatenate([mf_hist, misfit(g_f)[None]], axis=0),
    )


def run_eks(
    forward: Callable,
    theta0,
    y,
    noise_cov,
    prior_mean,
    prior_cov,
    n_iters: int,
    key,
    dt0: float = 1.0,
    transform: Optional[Callable] = None,
) -> EKIResult:
    """Ensemble Kalman Sampler (Garbuno-Inigo/Hoffmann/Li/Stuart 2020; the
    EKP.jl `Sampler` process), as ONE jitted `lax.scan`.

    Where EKI collapses its ensemble onto a point estimate, EKS runs the
    affine-invariant interacting Langevin diffusion whose invariant measure
    is the Bayesian posterior — at equilibrium the ensemble IS a posterior
    sample set (mean/cov pinned against the exact linear-Gaussian posterior
    in tests/test_calibrate.py). Discretization per iteration, with
    C = Cov(θ), E = g − ḡ, R = g − y:

        D_jk = ⟨Γ⁻¹(g_j − y), g_k − ḡ⟩ / J          (data-drift matrix)
        Δt   = dt0 / (‖D‖_F + 1e-8)                   (adaptive step)
        θ*   = θ − Δt·D θ                             (explicit data drift)
        θ⁺   = (I + Δt·C Γ₀⁻¹)⁻¹ (θ* + Δt·C Γ₀⁻¹ r₀)  (implicit prior drift)
        θ⁺  += √(2Δt)·chol(C) ξ,  ξ ~ N(0, I)         (Langevin noise)

    plus the Nüsken/Reich finite-ensemble correction +Δt·(P+1)/J·(θ − θ̄)
    to the drift. The implicit prior step keeps the iteration stable for any
    prior covariance Γ₀ = ``prior_cov`` (mean r₀ = ``prior_mean``). Returns
    an `EKIResult` (same fields; `theta` is the posterior sample ensemble).

    The Euler-Maruyama discretization carries an O(Δt) equilibrium-variance
    inflation of ≈ 1/(1 − λΔt/2) (λ the local drift rate) — the large
    default `dt0` is right for optimization-style runs (fast collapse onto
    the posterior mode region), but for quantitatively calibrated posterior
    SPREAD use `dt0 ≲ 0.1` and more iterations (the regime pinned against
    the exact linear-Gaussian posterior covariance in
    tests/test_calibrate.py::test_eks_samples_linear_gaussian_posterior)."""
    theta0 = jnp.atleast_2d(jnp.asarray(theta0))
    nj, p = theta0.shape
    y = jnp.asarray(y, theta0.dtype)
    d = y.shape[0]
    gamma = _as_cov(noise_cov, d, theta0.dtype)
    gamma_chol = jnp.linalg.cholesky(gamma)
    r0 = jnp.broadcast_to(jnp.asarray(prior_mean, theta0.dtype), (p,))
    gamma0 = _as_cov(prior_cov, p, theta0.dtype)
    eye_p = jnp.eye(p, dtype=theta0.dtype)

    fwd1 = forward if transform is None else (lambda t: forward(transform(t)))
    fwd = jax.vmap(fwd1)

    def misfit(g):
        r = jax.scipy.linalg.solve_triangular(
            gamma_chol, (y[None, :] - g).T, lower=True
        )
        return jnp.mean(r**2)

    def body(theta, k):
        g = fwd(theta)  # [J, D]
        g_mean = jnp.mean(g, axis=0)
        e = g - g_mean[None, :]  # [J, D]
        r = g - y[None, :]  # [J, D]
        # D_jk = ⟨Γ⁻¹ r_j, e_k⟩ / J
        d_mat = jnp.matmul(
            jnp.linalg.solve(gamma, r.T).T, e.T, precision=_HI
        ) / nj  # [J, J]
        dt = dt0 / (jnp.linalg.norm(d_mat) + 1e-8)
        th_a = theta - jnp.mean(theta, axis=0, keepdims=True)
        # explicit data drift + Nüsken/Reich finite-J correction
        theta_star = (
            theta
            - dt * jnp.matmul(d_mat, theta, precision=_HI)
            + dt * ((p + 1) / nj) * th_a
        )
        cov = jnp.matmul(th_a.T, th_a, precision=_HI) / nj  # [P, P]
        # implicit prior drift: (I + Δt C Γ₀⁻¹) θ⁺ = θ* + Δt C Γ₀⁻¹ r₀
        cg0 = jnp.matmul(
            cov, jnp.linalg.solve(gamma0, eye_p), precision=_HI
        )  # C Γ₀⁻¹
        lhs = eye_p + dt * cg0
        rhs = theta_star + dt * jnp.matmul(cg0, r0, precision=_HI)[None, :]
        theta_next = jnp.linalg.solve(lhs, rhs.T).T
        # Langevin noise ~ N(0, 2Δt C)
        chol = jnp.linalg.cholesky(cov + 1e-12 * eye_p)
        xi = jax.random.normal(k, (nj, p), theta0.dtype)
        theta_next = theta_next + jnp.sqrt(2.0 * dt) * jnp.matmul(
            xi, chol.T, precision=_HI
        )
        return theta_next, (theta, misfit(g))

    keys = jax.random.split(key, n_iters)
    theta_f, (th_hist, mf_hist) = jax.lax.scan(body, theta0, keys)
    g_f = fwd(theta_f)
    return EKIResult(
        theta_f,
        jnp.concatenate([th_hist, theta_f[None]], axis=0),
        jnp.concatenate([mf_hist, misfit(g_f)[None]], axis=0),
    )


class UKIResult(NamedTuple):
    """`mean`: final parameter mean [P]. `cov`: final parameter covariance
    [P, P] — for linear G this converges to the Fisher covariance
    (AᵀΓ⁻¹A)⁻¹, an uncertainty estimate EKI's collapsing ensemble does not
    provide. Histories include the prior state at index 0."""

    mean: jnp.ndarray
    cov: jnp.ndarray
    mean_history: jnp.ndarray
    cov_history: jnp.ndarray
    misfit_history: jnp.ndarray


def run_uki(
    forward: Callable,
    prior_mean,
    prior_cov,
    y,
    noise_cov,
    n_iters: int,
    alpha_reg: float = 1.0,
    transform: Optional[Callable] = None,
    jitter: float = 1e-10,
) -> UKIResult:
    """Unscented Kalman Inversion (Huang/Schneider/Stuart, JCP 2022) — the
    EKP.jl `Unscented` process, as ONE jitted `lax.scan`.

    Deterministic quadrature replaces the random ensemble: each iteration
    evaluates ``forward`` (vmapped) at the 2P symmetric cubature points
    θ_j = m ± √P·[chol(Ĉ)]_j (equal weights 1/(2P) — the λ=0 unscented
    transform, exact for linear G and free of negative weights at any P),
    then performs the Kalman update with the paper's default stabilizers
    Σ_ω = (2 − α²)·C_n (prediction inflation Ĉ = 2C_n at α=1) and Σ_ν = 2Γ:

        m̂ = r + α(m − r),   Ĉ = α²C + (2−α²)C
        m⁺ = m̂ + C_θg (C_gg + 2Γ)⁻¹ (y − ĝ)
        C⁺ = Ĉ − C_θg (C_gg + 2Γ)⁻¹ C_θgᵀ

    For linear G(θ) = Aθ and α=1 the fixed point is the weighted
    least-squares solution with C_∞ = (AᵀΓ⁻¹A)⁻¹ (pinned in
    tests/test_calibrate.py). ``alpha_reg`` < 1 regularizes toward the prior
    mean r (= ``prior_mean``). ``transform`` maps unconstrained θ into model
    space (e.g. `jnp.exp`), exactly as in `run_eki`. 2P+0 forward
    evaluations per iteration — for P ≪ J this is far cheaper per iteration
    than EKI and needs no PRNG key."""
    m0 = jnp.atleast_1d(jnp.asarray(prior_mean))
    p = m0.shape[0]
    c0 = jnp.asarray(prior_cov, m0.dtype)
    if c0.ndim == 0:
        c0 = c0 * jnp.eye(p, dtype=m0.dtype)
    elif c0.ndim == 1:
        c0 = jnp.diag(c0)
    y = jnp.asarray(y, m0.dtype)
    d = y.shape[0]
    gamma = _as_cov(noise_cov, d, m0.dtype)
    gamma_chol = jnp.linalg.cholesky(gamma)
    alpha = jnp.asarray(alpha_reg, m0.dtype)
    eye_p = jnp.eye(p, dtype=m0.dtype)

    fwd1 = forward if transform is None else (lambda t: forward(transform(t)))
    fwd = jax.vmap(fwd1)
    sqrt_p = jnp.sqrt(jnp.asarray(float(p), m0.dtype))

    def misfit(g_mean):
        r = jax.scipy.linalg.solve_triangular(
            gamma_chol, y - g_mean, lower=True
        )
        return jnp.mean(r**2)

    def body(carry, _):
        m, c = carry
        # prediction (artificial dynamics): regularize toward the prior
        # mean, inflate covariance by Σ_ω = (2−α²)C
        m_hat = m0 + alpha * (m - m0)
        c_hat = 2.0 * c  # α²C + (2−α²)C
        chol = jnp.linalg.cholesky(
            0.5 * (c_hat + c_hat.T) + jitter * eye_p
        )
        dev = sqrt_p * chol.T  # rows = √P · columns of chol  [P, P]
        pts = jnp.concatenate(
            [m_hat[None, :] + dev, m_hat[None, :] - dev], axis=0
        )  # [2P, P]
        g = fwd(pts)  # [2P, D]
        g_mean = jnp.mean(g, axis=0)
        th_a = pts - m_hat[None, :]
        g_a = g - g_mean[None, :]
        c_thg = jnp.matmul(th_a.T, g_a, precision=_HI) / (2 * p)  # [P, D]
        c_gg = (
            jnp.matmul(g_a.T, g_a, precision=_HI) / (2 * p) + 2.0 * gamma
        )  # [D, D], Σ_ν = 2Γ
        kal = jax.scipy.linalg.solve(c_gg, c_thg.T, assume_a="pos").T  # [P, D]
        m_next = m_hat + jnp.matmul(kal, y - g_mean, precision=_HI)
        c_next = c_hat - jnp.matmul(kal, c_thg.T, precision=_HI)
        c_next = 0.5 * (c_next + c_next.T)
        return (m_next, c_next), (m, c, misfit(g_mean))

    (m_f, c_f), (m_hist, c_hist, mf_hist) = jax.lax.scan(
        body, (m0, c0), None, length=n_iters
    )
    g_f = fwd1(m_f)
    return UKIResult(
        m_f,
        c_f,
        jnp.concatenate([m_hist, m_f[None]], axis=0),
        jnp.concatenate([c_hist, c_f[None]], axis=0),
        jnp.concatenate([mf_hist, misfit(g_f)[None]], axis=0),
    )


class GradFitResult(NamedTuple):
    params: jnp.ndarray
    loss_history: jnp.ndarray


def fit_gradient(
    loss: Callable,
    params0,
    n_iters: int,
    optimizer=None,
    learning_rate: float = 1e-2,
) -> GradFitResult:
    """Gradient-descent calibration: minimize ``loss(params)`` with optax
    (default: adam). The whole optimization is one jitted `lax.scan` —
    value_and_grad + optimizer update per iteration, no host sync. Exercises
    the end-to-end differentiability the Julia reference lacks
    (tests/test_autodiff.py)."""
    import optax

    opt = optimizer if optimizer is not None else optax.adam(learning_rate)
    params0 = jnp.asarray(params0)
    vg = jax.value_and_grad(loss)

    def body(carry, _):
        p, st = carry
        v, g = vg(p)
        updates, st = opt.update(g, st, p)
        return (optax.apply_updates(p, updates), st), v

    (p_f, _), hist = jax.lax.scan(
        body, (params0, opt.init(params0)), None, length=n_iters
    )
    return GradFitResult(p_f, hist)
