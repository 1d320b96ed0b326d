"""Multivariate normals with Woodbury covariance, and uniform mixtures.

Replaces the reference's use of ``Distributions.MvNormal`` over a
``WoodburyPDMat`` (``src/mvnormal.jl``) and ``Distributions.MixtureModel``
(``src/multipath.jl:215-216``). Everything is a registered pytree so
distributions can be stacked, ``vmap``-ed over trajectory candidates and
paths, and carried through ``lax.scan``.

The fused ``rand_and_logpdf`` mirrors reference ``src/mvnormal.jl:24-39``:
draw ``u ~ N(0, I)``, form ``x = L u + μ``, and get the log density from the
already-known ``‖u‖²`` and ``logdet Σ`` — no second solve:

    log q(x) = −(n·log 2π + logdet Σ + ‖u‖²) / 2
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from pathfinder_tpu.ops.woodbury import WoodburyPDMat

__all__ = ["MvNormal", "UniformMixture", "fit_mvnormal"]

_LOG_2PI = math.log(2.0 * math.pi)


def _tree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    return jax.tree_util.register_dataclass(cls)


@_tree_dataclass
class MvNormal:
    """N(μ, Σ) with ``Σ`` a :class:`WoodburyPDMat`."""

    mean: jax.Array  # (n,)
    cov: WoodburyPDMat

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    @property
    def dtype(self):
        return self.mean.dtype

    def logpdf(self, x: jax.Array) -> jax.Array:
        """Log density at ``x`` of shape ``(n,)`` or ``(n, N)``.

        Parity: ``Distributions.logpdf`` routed through ``PDMats.invquad``
        (``src/woodbury.jl:369-376``). XLA fuses the whiten + square-sum
        chain into the surrounding computation.
        """
        dx = x - (self.mean if x.ndim == 1 else self.mean[:, None])
        maha = self.cov.invquad(dx)
        return -0.5 * (self.dim * _LOG_2PI + self.cov.logdet() + maha)

    def sample(self, key: jax.Array, ndraws: int) -> jax.Array:
        """``(n, ndraws)`` draws: ``x = L u + μ``."""
        u = jax.random.normal(key, (self.dim, ndraws), dtype=self.dtype)
        return self.cov.unwhiten(u) + self.mean[:, None]

    def rand_and_logpdf(self, key: jax.Array, ndraws: int):
        """Fused sampling + log density (parity: ``rand_and_logpdf``,
        ``src/mvnormal.jl:24-39``). Returns ``(draws (n, ndraws), logq
        (ndraws,))`` — logq from the already-drawn whitened noise, no
        second solve."""
        u = jax.random.normal(key, (self.dim, ndraws), dtype=self.dtype)
        unormsq = jnp.sum(u * u, axis=0)
        x = self.cov.unwhiten(u) + self.mean[:, None]
        logq = -0.5 * (self.dim * _LOG_2PI + self.cov.logdet() + unormsq)
        return x, logq

    def entropy(self) -> jax.Array:
        return 0.5 * (self.dim * (_LOG_2PI + 1.0) + self.cov.logdet())


def fit_mvnormal(theta, grad_logp, cov: WoodburyPDMat) -> MvNormal:
    """One normal per trajectory point: μ = θ + Σ ∇logp(θ), Σ = H
    (parity: ``fit_mvnormals`` body, ``src/mvnormal.jl:14-21``)."""
    mu = theta + cov.mul(grad_logp)
    return MvNormal(mu, cov)


@_tree_dataclass
class UniformMixture:
    """Uniformly-weighted mixture of ``K`` MvNormals stored stacked.

    ``components`` is an :class:`MvNormal` whose every leaf has a leading
    ``K`` axis (a "batched distribution" — the JAX-native analog of the
    reference's ``MixtureModel(fits)``, ``src/multipath.jl:215-216``).
    """

    components: MvNormal  # batched: mean (K, n), cov leaves (K, ...)

    @property
    def ncomponents(self) -> int:
        return self.components.mean.shape[0]

    @property
    def dim(self) -> int:
        return self.components.mean.shape[1]

    def component(self, k) -> MvNormal:
        return jax.tree_util.tree_map(lambda leaf: leaf[k], self.components)

    def logpdf(self, x: jax.Array) -> jax.Array:
        """Mixture log density: ``logsumexp_k logpdf_k(x) − log K``."""
        per_comp = jax.vmap(lambda c: c.logpdf(x))(self.components)
        return jax.nn.logsumexp(per_comp, axis=0) - jnp.log(
            jnp.asarray(float(self.ncomponents), x.dtype)
        )

    def sample(self, key: jax.Array, ndraws: int):
        """Draw from the augmented mixture; returns ``(draws (n, ndraws),
        component_ids (ndraws,))``."""
        key_k, key_x = jax.random.split(key)
        ks = jax.random.randint(key_k, (ndraws,), 0, self.ncomponents)
        dim = self.dim
        dtype = self.components.dtype

        def draw_one(key, k):
            comp = self.component(k)
            u = jax.random.normal(key, (dim,), dtype=dtype)
            return comp.cov.unwhiten(u) + comp.mean

        keys = jax.random.split(key_x, ndraws)
        draws = jax.vmap(draw_one)(keys, ks)  # (ndraws, n)
        return draws.T, ks
