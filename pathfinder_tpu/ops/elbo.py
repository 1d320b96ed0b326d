"""Monte-Carlo ELBO estimation over trajectory candidates.

Parity target: ``src/elbo.jl``. The reference evaluates the L candidate
distributions in parallel task chunks with per-candidate seeds
(``src/elbo.jl:2-5``); here every candidate is evaluated by one batched
``vmap`` with a per-candidate ``fold_in`` key, which keeps the
reference's determinism contract (results independent of how work is
distributed) by construction.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from pathfinder_tpu.ops.mvnormal import MvNormal
from pathfinder_tpu.utils.misc import findmax_skipnan

__all__ = [
    "ELBOEstimate",
    "elbo_and_samples",
    "elbo_stats",
    "maximize_elbo",
    "maximize_elbo_chunked",
]


class ELBOEstimate(NamedTuple):
    """Parity: ``ELBOEstimate`` (``src/elbo.jl:22-29``)."""

    value: jax.Array  # () ELBO point estimate
    std_err: jax.Array  # () Monte-Carlo SE
    draws: jax.Array  # (d, ndraws)
    log_densities_target: jax.Array  # (ndraws,)
    log_densities_fit: jax.Array  # (ndraws,)
    log_density_ratios: jax.Array  # (ndraws,)

    def __repr__(self):  # pragma: no cover - cosmetic
        try:
            return f"ELBO estimate: {float(self.value):.2f} ± {float(self.std_err):.2f}"
        except Exception:
            return tuple.__repr__(self)


def elbo_and_samples(
    key: jax.Array, logp: Callable, dist: MvNormal, ndraws: int,
) -> ELBOEstimate:
    """One candidate's ELBO from ``ndraws`` fused draws (parity:
    ``elbo_and_samples``, ``src/elbo.jl:12-20``)."""
    draws, logq = dist.rand_and_logpdf(key, ndraws)
    # cast: user targets may compute in higher precision than the draws
    logp_x = jax.vmap(logp, in_axes=1)(draws).astype(draws.dtype)
    logr = logp_x - logq
    elbo = jnp.mean(logr)
    if ndraws > 1:
        var = jnp.sum((logr - elbo) ** 2) / (ndraws - 1)
        se = jnp.sqrt(var / ndraws)
    else:
        # a single draw has no variance information: SE is unknown, not
        # 0.0 (the reference's std of one draw is NaN too)
        se = jnp.full_like(elbo, jnp.nan)
    return ELBOEstimate(elbo, se, draws, logp_x, logq, logr)


def elbo_stats(key: jax.Array, logp: Callable, dist: MvNormal, ndraws: int):
    """Compact (value, std_err) ELBO estimate — the draws are NOT retained;
    they are deterministically replayable from the same key via
    :func:`elbo_and_samples` (pure-functional PRNG = free checkpoint/replay,
    replacing the reference's stored per-candidate draw matrices)."""
    est = elbo_and_samples(key, logp, dist, ndraws)
    return est.value, est.std_err


def maximize_elbo_chunked(
    key: jax.Array,
    logp: Callable,
    make_chunk_dists: Callable,
    num_candidates: int,
    chunk_size: int,
    ndraws: int,
    valid_mask: jax.Array,
    dtype=jnp.float32,
):
    """Chunked ELBO maximization: candidates are materialized ``chunk_size``
    at a time by ``make_chunk_dists(candidate_indices) -> batched MvNormal``
    inside an early-exiting ``lax.while_loop`` (chunks past the last valid
    candidate are skipped; their stats stay NaN), bounding memory to
    O(chunk · d · m) instead of O(L · d · m) — the fixed-shape answer to the
    reference's per-candidate task loop at large ``maxiters``. Forward-only
    (not reverse-differentiable). Returns ``(best_idx, values, ses,
    best_value)`` with per-candidate keys identical to
    :func:`maximize_elbo` (``fold_in(key, candidate_index)``)."""
    C = chunk_size
    nchunks = -(-num_candidates // C)
    pad_total = nchunks * C
    # chunks that start beyond the LAST valid candidate are skipped entirely
    # (a while_loop, not lax.map): with maxiters ≫ actual trajectory length
    # this saves most of the fit-construction work. The cutoff is the last
    # valid index + 1 (not the count), so scattered masks are handled too.
    n_valid_cand = jnp.max(
        jnp.where(
            valid_mask,
            jnp.arange(1, valid_mask.shape[0] + 1, dtype=jnp.int32),
            0,
        )
    )

    def one_chunk(c):
        idxs = c * C + jnp.arange(C)
        dists = make_chunk_dists(idxs)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(idxs)
        return jax.vmap(
            lambda k, dst: elbo_stats(k, logp, dst, ndraws)
        )(keys, dists)

    def cond(carry):
        c, _, _ = carry
        return (c < nchunks) & (c * C < n_valid_cand)

    def body(carry):
        c, vals, ses = carry
        v, s = one_chunk(c)
        return c + 1, vals.at[c].set(v), ses.at[c].set(s)

    init = (
        jnp.asarray(0),
        jnp.full((nchunks, C), jnp.nan, dtype),
        jnp.full((nchunks, C), jnp.nan, dtype),
    )
    _, vals, ses = jax.lax.while_loop(cond, body, init)
    vals = vals.reshape(pad_total)[:num_candidates]
    ses = ses.reshape(pad_total)[:num_candidates]
    # NaN == invalid for BOTH outputs: a chunk straddling the trajectory
    # end computes finite garbage stats from clipped trace points
    vals = jnp.where(valid_mask, vals, jnp.nan)
    ses = jnp.where(valid_mask, ses, jnp.nan)
    best, idx = findmax_skipnan(vals)
    return idx, vals, ses, best


def maximize_elbo(
    key: jax.Array,
    logp: Callable,
    dists: MvNormal,
    ndraws: int,
    valid_mask: jax.Array,
):
    """Estimate the ELBO of every candidate and take the NaN-skipping argmax
    (parity: ``maximize_elbo``, ``src/elbo.jl:1-10``).

    ``dists`` is a batched :class:`MvNormal` (leading axis = L candidates,
    trajectory iterations 1..L); ``valid_mask`` marks real iterations.
    Returns ``(best_index, estimates, best_value)`` where ``best_index``
    indexes the candidate axis.
    """
    L = dists.mean.shape[0]
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(L))
    ests = jax.vmap(lambda k, d: elbo_and_samples(k, logp, d, ndraws))(keys, dists)
    # NaN-mask the returned per-candidate stats at invalid slots, matching
    # maximize_elbo_chunked's contract (invalid == NaN, never garbage)
    ests = ests._replace(
        value=jnp.where(valid_mask, ests.value, jnp.nan),
        std_err=jnp.where(valid_mask, ests.std_err, jnp.nan),
    )
    best, idx = findmax_skipnan(ests.value)
    return idx, ests, best
