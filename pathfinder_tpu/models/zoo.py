"""Model zoo: target densities for tests, benchmarks, and examples.

Mirrors the targets the reference exercises in its tests and the driver's
benchmark configs (``BASELINE.json``): Gaussians (diagonal / correlated),
the banana density (``test/test_utils.jl:29-36``), Neal's funnel, and
Bayesian logistic regression (German-credit-scale).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from pathfinder_tpu.models.protocol import LogDensity

__all__ = [
    "StandardNormal",
    "CorrelatedGaussian",
    "NealsFunnel",
    "Banana",
    "LogisticRegression",
    "german_credit_synthetic",
]

_LOG_2PI = math.log(2.0 * math.pi)


def StandardNormal(dim: int) -> LogDensity:
    """N(0, I_dim)."""

    def logp(x):
        return -0.5 * (jnp.sum(x * x) + dim * _LOG_2PI)

    return LogDensity(logp=logp, dim=dim)


def CorrelatedGaussian(dim: int, rho: float = 0.8, seed: int = 0) -> LogDensity:
    """N(μ, Σ) with a random rotation of an AR(1)-style spectrum — a dense
    covariance exercising the full Woodbury logpdf/rand path (baseline
    config 2)."""
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal(dim)
    lam = rho ** np.arange(dim) + 0.05
    Q = np.linalg.qr(rng.standard_normal((dim, dim)))[0]
    cov = Q @ np.diag(lam) @ Q.T
    prec = np.linalg.inv(cov)
    _, ld = np.linalg.slogdet(cov)
    # constants stay host-side numpy: a device-resident jax.Array constant
    # is fetched back to the host at every cold MLIR lowering
    mu_j = mu
    prec_j = prec
    const = -0.5 * (dim * _LOG_2PI + ld)

    def logp(x):
        dx = x - mu_j
        return const - 0.5 * dx @ (prec_j @ dx)

    out = LogDensity(logp=logp, dim=dim)
    out.__dict__["mean"] = mu
    out.__dict__["cov"] = cov
    return out


def NealsFunnel(dim: int = 101, scale: float = 3.0) -> LogDensity:
    """Neal's funnel: v ~ N(0, scale²), xᵢ | v ~ N(0, exp(v)) for the
    remaining dim−1 coordinates (baseline config 3 uses dim=101)."""

    def logp(z):
        v, x = z[0], z[1:]
        lp_v = -0.5 * (v / scale) ** 2 - 0.5 * _LOG_2PI - jnp.log(scale)
        lp_x = -0.5 * jnp.sum(x * x) * jnp.exp(-v) - 0.5 * (dim - 1) * (
            _LOG_2PI + v
        )
        return lp_v + lp_x

    return LogDensity(logp=logp, dim=dim)


def Banana(b: float = 0.03, sigma: float = 10.0) -> LogDensity:
    """2-D banana density (parity: ``logp_banana``,
    ``test/test_utils.jl:29-36``)."""

    def logp(x):
        x1, x2 = x[0], x[1]
        return -0.5 * (x1 / sigma) ** 2 - 0.5 * (x2 + b * x1 * x1 - sigma * sigma * b) ** 2

    return LogDensity(logp=logp, dim=2)


def LogisticRegression(X, y, prior_scale: float = 10.0) -> LogDensity:
    """Bayesian logistic regression posterior over coefficients (baseline
    config 4: d ≈ 25, German credit)."""
    Xj = jnp.asarray(X)
    yj = jnp.asarray(y, dtype=Xj.dtype)
    d = Xj.shape[1]

    def logp(beta):
        logits = Xj @ beta
        loglik = jnp.sum(yj * logits - jnp.logaddexp(0.0, logits))
        logprior = -0.5 * jnp.sum((beta / prior_scale) ** 2)
        return loglik + logprior

    return LogDensity(logp=logp, dim=d)


def PoissonRegression(X, y, prior_scale: float = 5.0) -> LogDensity:
    """Bayesian Poisson (log-link) regression posterior over coefficients —
    a second GLM family next to :func:`LogisticRegression` (the reference's
    zoo stops at test densities; GLMs are the canonical Pathfinder use
    case, Zhang et al. 2022 §5)."""
    Xj = jnp.asarray(X)
    yj = jnp.asarray(y, dtype=Xj.dtype)
    d = Xj.shape[1]

    def logp(beta):
        eta = Xj @ beta
        # Poisson log-likelihood up to the data-only log(y!) constant
        loglik = jnp.sum(yj * eta - jnp.exp(eta))
        logprior = -0.5 * jnp.sum((beta / prior_scale) ** 2)
        return loglik + logprior

    return LogDensity(logp=logp, dim=d)


def poisson_synthetic(n: int = 500, d: int = 8, seed: int = 0):
    """Synthetic Poisson-regression data (bounded rates for stable tests)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)) / np.sqrt(d)
    X[:, 0] = 1.0
    beta_true = rng.standard_normal(d) * 0.5
    lam = np.exp(np.clip(X @ beta_true, -4.0, 4.0))
    y = rng.poisson(lam).astype(np.float64)
    return X, y, beta_true


def StudentTRegression(X, y, df: float = 4.0, sigma: float = 1.0,
                       prior_scale: float = 5.0) -> LogDensity:
    """Robust (Student-t likelihood) linear regression over coefficients —
    heavy-tailed residuals make the posterior non-Gaussian, a harder fit
    target than the conjugate linear model."""
    Xj = jnp.asarray(X)
    yj = jnp.asarray(y, dtype=Xj.dtype)
    d = Xj.shape[1]
    const = float(df)

    def logp(beta):
        z = (yj - Xj @ beta) / sigma
        loglik = -0.5 * (const + 1.0) * jnp.sum(jnp.log1p(z * z / const))
        logprior = -0.5 * jnp.sum((beta / prior_scale) ** 2)
        return loglik + logprior

    return LogDensity(logp=logp, dim=d)


def student_t_synthetic(n: int = 400, d: int = 8, df: float = 4.0,
                        seed: int = 0):
    """Synthetic robust-regression data with genuine t-distributed noise
    (and therefore outliers)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    X[:, 0] = 1.0
    beta_true = rng.standard_normal(d) * 0.5
    y = X @ beta_true + rng.standard_t(df, size=n)
    return X, y, beta_true


def OrderedLogisticRegression(X, y, n_cats: int, prior_scale: float = 5.0):
    """Ordinal (cumulative-logit) regression — the ordered-cutpoint GLM
    (Stan reference manual "ordered logistic"): ``P(y ≤ k | x) =
    σ(c_k − xβ)`` with strictly increasing cutpoints ``c``.

    Returns a :class:`~pathfinder_tpu.integrations.transforms.TransformedLogDensity`
    over constrained parameters ``[c (n_cats−1, ordered), β (d)]`` — the
    ``Ordered`` bijector (Stacked with Identity for β) handles the
    monotonicity constraint, so this family exercises the block-bijector
    machinery through the full pipeline. Category log-probabilities use
    the stable ``log(σ(b) − σ(a)) = logσ(b) + logσ(−a) + log1p(−e^{a−b})``
    identity (exact at both edge categories via ±200 padded cutpoints,
    with the exponent clamped so even a pad-crossing cutpoint excursion
    yields a finite penalty, never NaN).
    """
    from pathfinder_tpu.integrations.transforms import (
        Identity,
        Ordered,
        Stacked,
        TransformedLogDensity,
    )

    Xj = jnp.asarray(X)
    d = Xj.shape[1]
    K = int(n_cats)
    yk = jnp.asarray(y, jnp.int32)  # categories 0..K-1
    big = 200.0

    def logp_constrained(theta):
        c = theta[: K - 1]
        beta = theta[K - 1 :]
        eta = Xj @ beta
        c_pad = jnp.concatenate(
            [jnp.full((1,), -big, theta.dtype), c,
             jnp.full((1,), big, theta.dtype)]
        )
        a = c_pad[yk] - eta  # lower cutpoint minus linear predictor
        b = c_pad[yk + 1] - eta  # upper
        # a < b holds by the ordering except when a cutpoint excursion
        # crosses the ±big pad (|c| > 200 — absurd, but a line-search
        # trial can get there); clamp so log1p stays a huge finite
        # penalty instead of log(negative) = NaN poisoning the gradient
        diff = jnp.minimum(a - b, -1e-6)
        loglik = jnp.sum(
            jax.nn.log_sigmoid(b)
            + jax.nn.log_sigmoid(-a)
            + jnp.log1p(-jnp.exp(diff))
        )
        logprior = -0.5 * jnp.sum((theta / prior_scale) ** 2)
        return loglik + logprior

    bij = Stacked(((Ordered(), K - 1), (Identity(), d)))
    return TransformedLogDensity(
        logp_constrained=logp_constrained, bijector=bij, dim=K - 1 + d
    )


def NegativeBinomialRegression(X, y, prior_scale: float = 5.0):
    """Negative-binomial (NB2) regression with LEARNED dispersion — the
    overdispersed companion to :func:`PoissonRegression`. ``μ = exp(Xβ)``,
    ``y ~ NB2(μ, φ)`` with ``Var = μ + μ²/φ``; constrained parameters
    ``[β (d), φ (1, positive)]`` via ``Stacked((Identity, d), (Exp, 1))``
    — a mixed identity/positive block transform through the full
    pipeline. Prior: N(0, prior_scale²) on β and on log φ.

    Returns a :class:`~pathfinder_tpu.integrations.transforms.TransformedLogDensity`.
    """
    from jax.scipy.special import gammaln

    from pathfinder_tpu.integrations.transforms import (
        Exp,
        Identity,
        Stacked,
        TransformedLogDensity,
    )

    Xj = jnp.asarray(X)
    yj = jnp.asarray(y, Xj.dtype)
    d = Xj.shape[1]

    def logp_constrained(theta):
        beta = theta[:d]
        phi = theta[d]
        eta = jnp.clip(Xj @ beta, -20.0, 20.0)  # bound the rate like the
        # Poisson generator does; an unbounded exp overflows f32 at ~88
        mu = jnp.exp(eta)
        loglik = jnp.sum(
            gammaln(yj + phi)
            - gammaln(phi)
            - gammaln(yj + 1.0)
            + phi * (jnp.log(phi) - jnp.log(phi + mu))
            + yj * (eta - jnp.log(phi + mu))
        )
        logprior = -0.5 * jnp.sum((beta / prior_scale) ** 2)
        logprior += -0.5 * (jnp.log(phi) / prior_scale) ** 2
        return loglik + logprior

    bij = Stacked(((Identity(), d), (Exp(), 1)))
    return TransformedLogDensity(
        logp_constrained=logp_constrained, bijector=bij, dim=d + 1
    )


def negative_binomial_synthetic(
    n: int = 500, d: int = 6, phi: float = 3.0, seed: int = 0
):
    """Synthetic NB2 data with genuine overdispersion (gamma-Poisson
    mixture)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)) / np.sqrt(d)
    X[:, 0] = 1.0
    beta_true = rng.standard_normal(d) * 0.5
    mu = np.exp(np.clip(X @ beta_true, -4.0, 4.0))
    lam = rng.gamma(phi, mu / phi)  # Var(y) = mu + mu^2/phi
    y = rng.poisson(lam).astype(np.float64)
    return X, y, beta_true


def ordered_logistic_synthetic(
    n: int = 600, d: int = 4, n_cats: int = 4, seed: int = 0
):
    """Synthetic ordinal-regression data with well-separated cutpoints
    (gaps ≥ 0.5 by construction). NO intercept column: cumulative-logit
    models are invariant under ``c → c+δ, β₀ → β₀+δ``, so an intercept
    would leave a prior-only-identified ridge in the posterior."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)) / np.sqrt(d)
    beta_true = rng.standard_normal(d) * 0.8
    gaps = rng.uniform(0.5, 1.0, n_cats - 1)
    c_true = np.cumsum(gaps)
    c_true = c_true - c_true.mean()  # centered, strictly increasing
    eta = X @ beta_true
    u = rng.logistic(size=n)
    y = np.sum((eta + u)[:, None] > c_true[None, :], axis=1)
    return X, y, c_true, beta_true


__all__ += [
    "PoissonRegression",
    "poisson_synthetic",
    "StudentTRegression",
    "student_t_synthetic",
    "OrderedLogisticRegression",
    "ordered_logistic_synthetic",
    "NegativeBinomialRegression",
    "negative_binomial_synthetic",
]


def german_credit_synthetic(n: int = 1000, d: int = 25, seed: int = 0):
    """Synthetic logistic-regression data at German-credit scale (the real
    dataset is not shipped; shapes/conditioning match baseline config 4)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    X[:, 0] = 1.0  # intercept
    beta_true = rng.standard_normal(d) / np.sqrt(d)
    p = 1.0 / (1.0 + np.exp(-(X @ beta_true)))
    y = (rng.uniform(size=n) < p).astype(np.float64)
    return X, y, beta_true


def HierarchicalGaussian(dim: int = 1000, seed: int = 0) -> LogDensity:
    """Hierarchical posterior at baseline-config-5 scale: a global log-scale
    coordinate controlling the variance of dim−1 locals (funnel-like but
    milder), non-centered parameterization."""
    rng = np.random.default_rng(seed)
    # host-side numpy on purpose (see CorrelatedGaussian): jit embeds the
    # constant without a device round trip at lowering time
    obs = rng.standard_normal(dim - 1)

    def logp(z):
        log_tau, theta = z[0], z[1:]
        lp_tau = -0.5 * (log_tau / 1.0) ** 2
        lp_theta = -0.5 * jnp.sum(theta * theta)
        sigma = jnp.exp(0.5 * log_tau)
        lp_obs = -0.5 * jnp.sum((obs - sigma * theta) ** 2)
        return lp_tau + lp_theta + lp_obs

    return LogDensity(logp=logp, dim=dim)


def hierarchical_gaussian_truth(dim: int, seed: int = 0):
    """Exact posterior moments of :func:`HierarchicalGaussian` by 1-D
    quadrature: θ is conditionally Gaussian given ``log_tau`` and the
    ``log_tau`` marginal is one-dimensional, so every moment reduces to an
    integral over ``log_tau`` — machine-precision ground truth (the
    truth-anchored referee for the bench's moment-error columns and the
    NUTS validation tests; no MCMC needed).

    Returns ``(mean (dim,), sd (dim,))`` ordered ``[log_tau, theta...]``.
    """
    d = dim
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal(d - 1)  # must match HierarchicalGaussian
    S = float(np.sum(obs**2))
    lt = np.linspace(-10.0, 10.0, 40001)
    s2 = np.exp(lt)  # sigma^2
    logw = (
        -0.5 * lt**2
        - 0.5 * ((d - 1) * np.log(2 * np.pi * (1.0 + s2)) + S / (1.0 + s2))
    )
    logw -= logw.max()
    w = np.exp(logw)
    w /= w.sum()
    sig = np.sqrt(s2)
    mean_lt = float(np.sum(w * lt))
    var_lt = float(np.sum(w * (lt - mean_lt) ** 2))
    A = float(np.sum(w * sig / (1.0 + s2)))  # E[sigma/(1+sigma^2)]
    B = float(np.sum(w / (1.0 + s2)))  # E[1/(1+sigma^2)]
    C = float(np.sum(w * s2 / (1.0 + s2) ** 2))  # E[sigma^2/(1+sigma^2)^2]
    mean_theta = obs * A
    var_theta = B + obs**2 * C - (obs * A) ** 2
    mean = np.concatenate([[mean_lt], mean_theta])
    sd = np.sqrt(np.concatenate([[var_lt], var_theta]))
    return mean, sd


__all__.append("HierarchicalGaussian")
__all__.append("hierarchical_gaussian_truth")
