"""Dynamic NUTS with the low-rank Woodbury metric, fully ``lax``-native.

Multinomial No-U-Turn sampler (Hoffman & Gelman 2014 termination; Betancourt
2017 multinomial state sampling) implemented **iteratively** — no recursion,
fixed ``max_depth`` — so the whole transition jits and vmaps:

* subtrees are built leaf-by-leaf inside a ``while_loop`` with a checkpoint
  stack of size ``max_depth``: an aligned block of size 2^k ending at leaf
  ``n`` (binary: k trailing ones) is U-turn-checked against the checkpoint
  stored when its start leaf ``a = n − 2^k + 1`` was visited; block starts
  live at stack index ``popcount(a)``. This reproduces the recursive
  algorithm's complete set of sub-tree checks with O(max_depth) memory.
* tree doubling is the outer ``while_loop``; a subtree that turns/diverges
  is discarded whole (edges not advanced), matching the recursive semantics.
* the U-turn criterion is the generalized one: ``ρ·M⁻¹p_start ≤ 0`` or
  ``ρ·M⁻¹p_end ≤ 0`` with ρ the block momentum sum — all metric products in
  O(d·m) low-rank form via :class:`WoodburyMetric`.

This supplies the reference's "initialize NUTS from Pathfinder" use case
(``docs/src/examples/initializing-hmc.md``; the reference delegates the
sampler to AdvancedHMC/DynamicHMC — here it is in-repo) with dual-averaging
step-size warmup.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from pathfinder_tpu.integrations.hmc import (
    WoodburyMetric,
    da_init,
    da_update,
    leapfrog_step,
)

__all__ = [
    "nuts",
    "nuts_chains",
    "nuts_warm_start",
    "warm_start_chains",
    "NUTSResult",
]

_MAX_DELTA_H = 1000.0  # divergence threshold (Stan's default)


class _Point(NamedTuple):
    x: jax.Array
    p: jax.Array
    g: jax.Array  # ∇logp(x)
    logp: jax.Array


def _leapfrog1(vg, metric, pt: _Point, eps):
    return _Point(*leapfrog_step(vg, metric, pt.x, pt.p, pt.g, eps))


def _energy(metric, pt: _Point):
    return pt.logp - metric.kinetic_energy(pt.p)


def _popcount(n):
    return jax.lax.population_count(n.astype(jnp.uint32)).astype(jnp.int32)


def _uturn(metric, rho, p_start, p_end):
    return (jnp.vdot(rho, metric.grad_kinetic(p_start)) <= 0) | (
        jnp.vdot(rho, metric.grad_kinetic(p_end)) <= 0
    )


class _SubtreeState(NamedTuple):
    leaf: jax.Array  # next leaf index within the subtree
    edge: _Point  # current integration edge (frame-adjusted)
    rho: jax.Array  # subtree momentum sum (true frame)
    prop_x: jax.Array
    prop_g: jax.Array
    prop_logp: jax.Array
    log_sum_w: jax.Array
    accept_sum: jax.Array
    n_leaves: jax.Array
    turning: jax.Array
    diverging: jax.Array
    p_ckpt: jax.Array  # (max_depth+1, d) momentum checkpoints (true frame)
    rho_ckpt: jax.Array  # (max_depth+1, d) rho-prefix checkpoints


def _build_subtree(
    key, vg, metric, edge: _Point, sign, n_steps, eps, h0, max_depth
):
    """Integrate ``n_steps`` leaves from ``edge`` in direction ``sign``,
    with complete aligned-block U-turn checks. All momenta reported in the
    true (trajectory-time) frame."""
    d = edge.x.shape[0]
    dtype = edge.x.dtype
    neg_inf = jnp.asarray(-jnp.inf, dtype)

    # integrate in a flipped frame so the integrator always steps +eps
    edge_f = edge._replace(p=sign * edge.p)

    init = _SubtreeState(
        leaf=jnp.asarray(0, jnp.int32),
        edge=edge_f,
        rho=jnp.zeros((d,), dtype),
        prop_x=edge.x,
        prop_g=edge.g,
        prop_logp=edge.logp,
        log_sum_w=neg_inf,
        accept_sum=jnp.zeros((), dtype),
        n_leaves=jnp.asarray(0, jnp.int32),
        turning=jnp.asarray(False),
        diverging=jnp.asarray(False),
        p_ckpt=jnp.zeros((max_depth + 1, d), dtype),
        rho_ckpt=jnp.zeros((max_depth + 1, d), dtype),
    )

    def cond(s: _SubtreeState):
        return (s.leaf < n_steps) & ~s.turning & ~s.diverging

    def body(s: _SubtreeState):
        n = s.leaf
        new_f = _leapfrog1(vg, metric, s.edge, eps)
        p_true = sign * new_f.p
        h = _energy(metric, new_f._replace(p=p_true))
        delta = h - h0
        delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
        diverging = delta < -_MAX_DELTA_H

        # multinomial proposal update within the subtree
        log_w = delta
        log_sum_new = jnp.logaddexp(s.log_sum_w, log_w)
        take = jnp.log(
            jax.random.uniform(jax.random.fold_in(key, n), dtype=dtype)
        ) < (log_w - log_sum_new)
        prop_x = jnp.where(take, new_f.x, s.prop_x)
        prop_g = jnp.where(take, new_f.g, s.prop_g)
        prop_logp = jnp.where(take, new_f.logp, s.prop_logp)

        accept_sum = s.accept_sum + jnp.minimum(1.0, jnp.exp(delta))

        rho_new = s.rho + p_true

        # checkpoint store at even leaves: stack idx = popcount(n)
        is_even = (n % 2) == 0
        ck_idx = _popcount(n)
        p_ckpt = jnp.where(
            is_even, s.p_ckpt.at[ck_idx].set(p_true), s.p_ckpt
        )
        rho_ckpt = jnp.where(
            is_even, s.rho_ckpt.at[ck_idx].set(s.rho), s.rho_ckpt
        )

        # U-turn checks at odd leaves over trailing-ones aligned blocks:
        # block k has start a = n+1-2^k, checkpoint idx popcount(a),
        # running from idx_max = popcount(n >> 1) down to idx_min. For an
        # even n, trailing_ones = 0 makes the bounds empty — so traced loop
        # bounds replace the old fixed (max_depth+1)-iteration masked loop,
        # cutting the per-leaf cost from 2(max_depth+1) O(d·m) matvecs to
        # ~2 on average (trailing_ones averages 1), with the loop-invariant
        # M⁻¹·p_end matvec hoisted out.
        idx_max = _popcount(n >> 1)
        # trailing ones of n = the bits where n is 1 and n+1 is 0 —
        # one fused popcount instead of a data-dependent while_loop in
        # the hottest (per-leaf, vmapped) loop of the sampler
        trailing_ones = _popcount(n & ~(n + 1))
        idx_min = idx_max - trailing_ones + 1

        v_end = metric.grad_kinetic(p_true)

        def check_block(i, turning):
            rho_block = rho_new - rho_ckpt[i]
            t = (jnp.vdot(rho_block, metric.grad_kinetic(p_ckpt[i])) <= 0) | (
                jnp.vdot(rho_block, v_end) <= 0
            )
            return turning | t

        turning = jax.lax.fori_loop(
            idx_min, idx_max + 1, check_block, jnp.asarray(False)
        )

        return _SubtreeState(
            leaf=n + 1,
            edge=new_f,
            rho=rho_new,
            prop_x=prop_x,
            prop_g=prop_g,
            prop_logp=prop_logp,
            log_sum_w=log_sum_new,
            accept_sum=accept_sum,
            n_leaves=s.n_leaves + 1,
            turning=turning,
            diverging=diverging,
            p_ckpt=p_ckpt,
            rho_ckpt=rho_ckpt,
        )

    out = lax.while_loop(cond, body, init)
    edge_true = out.edge._replace(p=sign * out.edge.p)
    return out, edge_true


class _TreeState(NamedTuple):
    left: _Point
    right: _Point
    rho: jax.Array
    prop_x: jax.Array
    prop_g: jax.Array
    prop_logp: jax.Array
    log_sum_w: jax.Array
    depth: jax.Array
    turning: jax.Array
    diverging: jax.Array
    accept_sum: jax.Array
    n_leaves: jax.Array


def _nuts_transition(key, vg, metric, pt0: _Point, eps, max_depth):
    dtype = pt0.x.dtype
    h0 = _energy(metric, pt0)

    tree = _TreeState(
        left=pt0,
        right=pt0,
        rho=pt0.p,
        prop_x=pt0.x,
        prop_g=pt0.g,
        prop_logp=pt0.logp,
        log_sum_w=jnp.zeros((), dtype),  # initial point has weight exp(0)
        depth=jnp.asarray(0, jnp.int32),
        turning=jnp.asarray(False),
        diverging=jnp.asarray(False),
        accept_sum=jnp.zeros((), dtype),
        n_leaves=jnp.asarray(0, jnp.int32),
    )

    def cond(t: _TreeState):
        return (t.depth < max_depth) & ~t.turning & ~t.diverging

    def body(t: _TreeState):
        k_dir = jax.random.fold_in(jax.random.fold_in(key, 1), t.depth)
        k_sub = jax.random.fold_in(jax.random.fold_in(key, 2), t.depth)
        k_merge = jax.random.fold_in(jax.random.fold_in(key, 3), t.depth)
        go_right = jax.random.bernoulli(k_dir)
        sign = jnp.where(go_right, 1.0, -1.0).astype(dtype)
        edge = jax.tree_util.tree_map(
            lambda a, b: jnp.where(go_right, a, b), t.right, t.left
        )
        n_steps = jnp.left_shift(jnp.asarray(1, jnp.int32), t.depth)
        sub, new_edge = _build_subtree(
            k_sub, vg, metric, edge, sign, n_steps, eps, h0, max_depth
        )

        ok = ~sub.turning & ~sub.diverging
        # biased progressive merge (Betancourt 2017)
        take = jnp.log(jax.random.uniform(k_merge, dtype=dtype)) < (
            sub.log_sum_w - t.log_sum_w
        )
        take = take & ok
        prop_x = jnp.where(take, sub.prop_x, t.prop_x)
        prop_g = jnp.where(take, sub.prop_g, t.prop_g)
        prop_logp = jnp.where(take, sub.prop_logp, t.prop_logp)
        log_sum_w = jnp.where(
            ok, jnp.logaddexp(t.log_sum_w, sub.log_sum_w), t.log_sum_w
        )

        left = jax.tree_util.tree_map(
            lambda old, new: jnp.where(ok & ~go_right, new, old), t.left, new_edge
        )
        right = jax.tree_util.tree_map(
            lambda old, new: jnp.where(ok & go_right, new, old), t.right, new_edge
        )
        rho = jnp.where(ok, t.rho + sub.rho, t.rho)
        full_turn = ok & _uturn(metric, rho, left.p, right.p)

        return _TreeState(
            left=left,
            right=right,
            rho=rho,
            prop_x=prop_x,
            prop_g=prop_g,
            prop_logp=prop_logp,
            log_sum_w=log_sum_w,
            depth=t.depth + 1,
            turning=sub.turning | full_turn,
            diverging=sub.diverging,
            accept_sum=t.accept_sum + sub.accept_sum,
            n_leaves=t.n_leaves + sub.n_leaves,
        )

    out = lax.while_loop(cond, body, tree)
    accept_stat = out.accept_sum / jnp.maximum(out.n_leaves, 1)
    return out.prop_x, out.prop_logp, out.prop_g, accept_stat, out


class NUTSResult(NamedTuple):
    samples: jax.Array  # (num_samples, d)
    log_densities: jax.Array  # (num_samples,)
    accept_stat: jax.Array  # (num_samples,)
    tree_depths: jax.Array  # (num_samples,)
    diverging: jax.Array  # (num_samples,) bool
    step_size: jax.Array  # ()
    # (d,) adapted diagonal M⁻¹ when adapt_mass_matrix=True, else None
    inv_mass_diag: Optional[jax.Array] = None
    # exact leapfrog counts per transition — each leapfrog is exactly one
    # logp+grad evaluation, so these are the sampler's cost ledger (the
    # reference's headline claim is fewer gradient evals than NUTS warmup,
    # docs/src/index.md:11; these make that comparison exact, Stan's
    # n_leapfrog__ analog). Total evals = 1 (initial point)
    # + sum(warmup_n_leapfrogs) + sum(n_leapfrogs).
    n_leapfrogs: Optional[jax.Array] = None  # (num_samples,) int32
    warmup_n_leapfrogs: Optional[jax.Array] = None  # (num_warmup,) int32


def _warmup_schedule(num_warmup, init_buffer, term_buffer, base_window):
    """Stan's three-phase warmup schedule as host-side boolean masks:
    ``slow[t]`` marks steps whose draw feeds the covariance estimator,
    ``win_end[t]`` marks the last step of each expanding adaptation window
    (window sizes double; the final window absorbs the remainder)."""
    import numpy as np

    if init_buffer < 0 or term_buffer < 0 or base_window < 1:
        raise ValueError(
            "warmup schedule requires init_buffer >= 0, term_buffer >= 0, "
            f"base_window >= 1; got ({init_buffer}, {term_buffer}, "
            f"{base_window})"
        )
    if num_warmup < init_buffer + term_buffer + base_window:
        # Stan's rescaling for short warmups (windowed_adaptation.hpp)
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.10 * num_warmup)
        base_window = max(num_warmup - init_buffer - term_buffer, 1)
    slow = np.zeros(num_warmup, bool)
    win_end = np.zeros(num_warmup, bool)
    lo, hi = init_buffer, num_warmup - term_buffer
    slow[lo:hi] = True
    t, size = lo, base_window
    while t < hi:
        end = t + size
        if end + 2 * size > hi:
            end = hi
        win_end[min(end, hi) - 1] = True
        t, size = end, size * 2
    return slow, win_end


@partial(
    jax.jit,
    static_argnames=(
        "value_and_grad",
        "num_samples",
        "num_warmup",
        "max_depth",
        "adapt_mass_matrix",
        "init_buffer",
        "term_buffer",
        "base_window",
    ),
)
def nuts(
    key: jax.Array,
    value_and_grad: Callable,
    metric: Optional[WoodburyMetric],
    x0: jax.Array,
    num_samples: int = 1000,
    num_warmup: int = 500,
    max_depth: int = 10,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_mass_matrix: bool = False,
    init_buffer: int = 75,
    term_buffer: int = 50,
    base_window: int = 25,
) -> NUTSResult:
    """Run one NUTS chain (``vmap`` for several).

    ``metric=None`` starts from the identity metric. With the default
    ``adapt_mass_matrix=False`` the metric stays fixed — the Pathfinder
    warm-start workflow, where the fit covariance *is* the metric. With
    ``adapt_mass_matrix=True`` the warmup runs Stan's windowed adaptation:
    expanding slow windows accumulate a Welford estimate of the posterior
    variance, each window end replaces the metric with the regularized
    diagonal estimate ``(n/(n+5))·var + 1e-3·(5/(n+5))`` and restarts the
    dual-averaging step-size adaptation — making the sampler standalone-
    complete (the initial metric, e.g. the Pathfinder fit, then only seeds
    the first window)."""
    dtype = x0.dtype
    d = x0.shape[0]
    if metric is None:
        metric = WoodburyMetric.diag(jnp.ones((d,), dtype))
    logp0, g0 = value_and_grad(x0)

    # dual-averaging state (mu, log_eps, log_eps_bar, h_acc, t) shared
    # with hmc.py; mu is carried so windowed adaptation can restart the
    # averaging mid-warmup
    da0 = da_init(init_step_size, dtype)

    if adapt_mass_matrix:
        if metric.minv.A.ndim != 1:
            raise ValueError(
                "adapt_mass_matrix=True requires a diagonal-A metric "
                "(every Pathfinder fit metric is); got a dense A"
            )
        slow_np, win_end_np = _warmup_schedule(
            num_warmup, init_buffer, term_buffer, base_window
        )
        slow_flags = jnp.asarray(slow_np)
        win_end_flags = jnp.asarray(win_end_np)
        wf0 = (
            jnp.zeros((), dtype),  # count
            jnp.zeros((d,), dtype),  # mean
            jnp.zeros((d,), dtype),  # M2
        )

        def step(carry, inp):
            x, logp, g, da, minv, wf = carry
            k, slow, win_end = inp
            met = WoodburyMetric(minv)
            p = met.sample_momentum(jax.random.fold_in(k, 0))
            eps = jnp.exp(da[1])
            x_n, logp_n, g_n, astat, tree = _nuts_transition(
                k, value_and_grad, met, _Point(x, p, g, logp), eps, max_depth
            )
            da_n = da_update(da, astat, target_accept)

            # Welford accumulation over the slow-window draws
            cnt, mean, m2 = wf
            cnt1 = cnt + 1.0
            delta = x_n - mean
            mean1 = mean + delta / cnt1
            m2_1 = m2 + delta * (x_n - mean1)
            cnt = jnp.where(slow, cnt1, cnt)
            mean = jnp.where(slow, mean1, mean)
            m2 = jnp.where(slow, m2_1, m2)

            # window end: swap in the regularized diagonal estimate,
            # reset the estimator, restart dual averaging at the current eps
            var = m2 / jnp.maximum(cnt - 1.0, 1.0)
            var_reg = (cnt / (cnt + 5.0)) * var + 1e-3 * (5.0 / (cnt + 5.0))
            var_reg = jnp.maximum(var_reg, 1e-10)
            cand = WoodburyMetric.diag(
                var_reg, rank=minv.B.shape[1]
            ).minv
            minv = jax.tree_util.tree_map(
                lambda a, b: jnp.where(win_end, a, b), cand, minv
            )
            cnt = jnp.where(win_end, 0.0, cnt)
            mean = jnp.where(win_end, jnp.zeros_like(mean), mean)
            m2 = jnp.where(win_end, jnp.zeros_like(m2), m2)
            # restart dual averaging seeded from the *averaged* log step size
            # (log_eps_bar), which is stable against the last iteration's
            # noise. Deviation from Stan, which re-runs its step-size
            # heuristic against the new metric; the averaged value is the
            # best available metric-free proxy and re-adapts within a few
            # iterations.
            mu_r = jnp.log(10.0) + da_n[2]
            da_n = tuple(
                jnp.where(win_end, new, old)
                for new, old in zip(
                    (mu_r, da_n[2], da_n[2], jnp.zeros((), dtype),
                     jnp.zeros((), dtype)),
                    da_n,
                )
            )

            return (
                (x_n, logp_n, g_n, da_n, minv, (cnt, mean, m2)),
                (x_n, astat, logp_n, tree.depth, tree.diverging,
                 tree.n_leaves),
            )

        keys_w = jax.random.split(jax.random.fold_in(key, 0), num_warmup)
        carry = (x0, logp0, g0, da0, metric.minv, wf0)
        carry, ys_w = lax.scan(step, carry, (keys_w, slow_flags, win_end_flags))
        x, logp, g, da, minv_final, _ = carry
        warmup_n_leapfrogs = ys_w[5]
        metric = WoodburyMetric(minv_final)
        inv_mass_diag = minv_final.diag()
    else:

        def step(carry, k):
            x, logp, g, da = carry
            p = metric.sample_momentum(jax.random.fold_in(k, 0))
            eps = jnp.exp(da[1])
            x_n, logp_n, g_n, astat, tree = _nuts_transition(
                k, value_and_grad, metric, _Point(x, p, g, logp), eps, max_depth
            )
            return (
                (x_n, logp_n, g_n, da_update(da, astat, target_accept)),
                (x_n, astat, logp_n, tree.depth, tree.diverging,
                 tree.n_leaves),
            )

        keys_w = jax.random.split(jax.random.fold_in(key, 0), num_warmup)
        carry, ys_w = lax.scan(step, (x0, logp0, g0, da0), keys_w)
        x, logp, g, da = carry
        warmup_n_leapfrogs = ys_w[5]
        inv_mass_diag = None
    eps_final = jnp.exp(da[2])

    def sample_step(carry, k):
        x, logp, g = carry
        p = metric.sample_momentum(jax.random.fold_in(k, 0))
        pt0 = _Point(x, p, g, logp)
        x_n, logp_n, g_n, astat, tree = _nuts_transition(
            k, value_and_grad, metric, pt0, eps_final, max_depth
        )
        return (x_n, logp_n, g_n), (
            x_n, logp_n, astat, tree.depth, tree.diverging, tree.n_leaves
        )

    keys_s = jax.random.split(jax.random.fold_in(key, 1), num_samples)
    _, (xs, lps, astats, depths, divs, n_lf) = lax.scan(
        sample_step, (x, logp, g), keys_s
    )
    # A non-finite starting logp (x0 outside the support, or a NaN
    # gradient) makes every reservoir weight infinite and the chain would
    # silently return num_samples copies of x0 with healthy-looking
    # accept_stat=1 diagnostics. Stan validates the initial energy and
    # aborts; inside jit we cannot raise on a traced value, so the outputs
    # are NaN-poisoned to make the failure visible (the host-level entry
    # points validate and raise before reaching this).
    ok0 = jnp.isfinite(logp0) & jnp.all(jnp.isfinite(g0))
    nanlike = lambda a: jnp.where(ok0, a, jnp.nan)
    return NUTSResult(
        samples=nanlike(xs),
        log_densities=nanlike(lps),
        accept_stat=jnp.where(ok0, astats, 0.0),
        tree_depths=depths,
        diverging=divs | ~ok0,
        step_size=eps_final,
        inv_mass_diag=inv_mass_diag,
        n_leapfrogs=n_lf,
        warmup_n_leapfrogs=warmup_n_leapfrogs,
    )


def nuts_chains(
    key: jax.Array,
    value_and_grad: Callable,
    metric: Optional[WoodburyMetric],
    x0s: jax.Array,
    mesh=None,
    **kwargs,
):
    """Run one NUTS chain per row of ``x0s`` ((C, d), vmapped — all chains
    integrate in lockstep on the device) and return ``(result, summary)``:
    the chain-stacked :class:`NUTSResult` plus the
    :func:`~pathfinder_tpu.utils.diagnostics.summarize` dict
    (mean/sd/ess_bulk/ess_tail/rhat over the (C, N, d) sample stack) —
    the multi-chain workflow of the reference's integration tests
    (``test/integration/Turing/runtests.jl:111-176``) as one call.

    ``mesh``: an optional :class:`jax.sharding.Mesh` to shard the chains
    axis over devices (one independent group of chains per chip — the
    serving-scale layout; chains are independent, so XLA partitions the
    whole sampler with no cross-device collectives). ``C`` must be
    divisible by the first mesh axis's size (the chain axis shards over
    that axis only). Per-chain keys are split from ``key``
    before placement, so every chain draws the same random numbers; the
    floating-point trajectories themselves may differ from the unsharded
    run (per-device batch width changes XLA's code across the chain axis
    — measured ~5e-15 in f64 on the CPU; on a GPU the chains diverged
    into different, equally valid runs).

    ``value_and_grad`` is a static (identity-keyed) jit argument: pass the
    *same callable object* across calls to reuse the compiled sampler —
    e.g. a target's cached ``.value_and_grad`` attribute, not a fresh
    ``jax.value_and_grad(logp)`` per call."""
    from pathfinder_tpu.utils.diagnostics import summarize

    C = x0s.shape[0]
    # Stan-style initial-energy validation at the host boundary: a chain
    # started at non-finite logp/grad would silently NaN-poison (see the
    # note in nuts()); one batched eval per chain is negligible here.
    lp0, g0 = jax.vmap(value_and_grad)(x0s)
    bad = ~(
        jnp.isfinite(lp0) & jnp.all(jnp.isfinite(g0), axis=1)
    )
    if bool(bad.any()):
        import numpy as _np

        raise ValueError(
            f"chains {_np.nonzero(_np.asarray(bad))[0].tolist()} start at "
            "non-finite log density or gradient; choose in-support x0s"
        )
    keys = jax.random.split(key, C)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        axis = mesh.axis_names[0]
        # the chain axis shards over the FIRST mesh axis only — validate
        # against that axis's size, not the total device count (a 2-D
        # mesh's second axis replicates)
        n_dev = int(mesh.shape[axis])
        if C % n_dev != 0:
            raise ValueError(
                f"{C} chains are not divisible over the {n_dev}-wide "
                f"'{axis}' mesh axis; pad x0s or change the chain count."
            )
        spec = NamedSharding(mesh, PartitionSpec(axis))
        keys = jax.device_put(keys, spec)
        x0s = jax.device_put(x0s, spec)
    out = _nuts_vmapped(keys, value_and_grad, metric, x0s, **kwargs)
    return out, summarize(out.samples)


# One persistent outer jit for nuts_chains in BOTH layouts: sharded and
# unsharded run the same compiled-program structure (mesh placement is the
# only difference, so the bit-identity contract holds), and repeated calls
# with the same target/shapes hit the pjit cache instead of re-tracing a
# per-call lambda (which would recompile the whole sampler every call).
@partial(
    jax.jit,
    static_argnames=(
        "value_and_grad",
        "num_samples",
        "num_warmup",
        "max_depth",
        "adapt_mass_matrix",
        "init_buffer",
        "term_buffer",
        "base_window",
    ),
)
def _nuts_vmapped(
    keys: jax.Array,
    value_and_grad: Callable,
    metric: Optional[WoodburyMetric],
    x0s: jax.Array,
    num_samples: int = 1000,
    num_warmup: int = 500,
    max_depth: int = 10,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_mass_matrix: bool = False,
    init_buffer: int = 75,
    term_buffer: int = 50,
    base_window: int = 25,
):
    return jax.vmap(
        lambda k, x0: nuts(
            k,
            value_and_grad,
            metric,
            x0,
            num_samples=num_samples,
            num_warmup=num_warmup,
            max_depth=max_depth,
            init_step_size=init_step_size,
            target_accept=target_accept,
            adapt_mass_matrix=adapt_mass_matrix,
            init_buffer=init_buffer,
            term_buffer=term_buffer,
            base_window=base_window,
        )
    )(keys, x0s)


def warm_start_chains(result, n_chains: int, *, draw_indices=None):
    """``(value_and_grad, metric, x0s)`` for a multi-chain NUTS/HMC warm
    start from a Pathfinder result — the reference's headline workflow
    (initial points + metric, ``docs/src/examples/initializing-hmc.md:13-17``)
    for ``C`` chains in one call::

        vg, metric, x0s = warm_start_chains(result, 4)
        out, summary = nuts_chains(key, vg, metric, x0s, num_warmup=100)

    ``draw_indices`` selects which of the result's (PSIS-resampled for
    multipath) draws become chain inits; default the first ``n_chains``.
    The metric is shared across chains: the fit covariance (single path)
    or the component of the first selected draw (multipath — no single
    Woodbury matrix represents a mixture; see
    :meth:`WoodburyMetric.from_result`)."""
    from pathfinder_tpu.integrations.hmc import (
        resolve_result_value_and_grad,
    )

    ndraws = result.draws.shape[1]
    if draw_indices is None:
        if n_chains > ndraws:
            raise ValueError(
                f"need {n_chains} chain inits but the result has only "
                f"{ndraws} draws; rerun with more ndraws or pass "
                "draw_indices"
            )
        draw_indices = range(n_chains)
    draw_indices = [int(i) for i in draw_indices]
    if len(draw_indices) != n_chains:
        raise ValueError(
            f"draw_indices has {len(draw_indices)} entries but "
            f"n_chains={n_chains}"
        )
    # Validate EVERY index — JAX gather would silently clamp an
    # out-of-range entry to the last draw (same hazard as
    # WoodburyMetric.from_result, which only sees draw_indices[0]).
    bad = [i for i in draw_indices if not -ndraws <= i < ndraws]
    if bad:
        raise IndexError(
            f"draw_indices {bad} out of range for a result with "
            f"{ndraws} draws"
        )
    vg = resolve_result_value_and_grad(result)
    metric = WoodburyMetric.from_result(result, draw_indices[0])
    x0s = result.draws[:, jnp.asarray(draw_indices)].T
    return vg, metric, x0s


def nuts_warm_start(
    key: jax.Array,
    result,
    *,
    num_samples: int = 1000,
    num_warmup: int = 500,
    max_depth: int = 10,
    draw_index: int = 0,
    **kwargs,
) -> NUTSResult:
    """NUTS initialized from a Pathfinder result: position = a Pathfinder
    draw, metric = the fit covariance (the reference's headline workflow)."""
    from pathfinder_tpu.integrations.hmc import resolve_result_value_and_grad

    vg = resolve_result_value_and_grad(result)
    metric = WoodburyMetric.from_result(result, draw_index)
    x0 = result.draws[:, draw_index]
    return nuts(
        key,
        vg,
        metric,
        x0,
        num_samples=num_samples,
        num_warmup=num_warmup,
        max_depth=max_depth,
        **kwargs,
    )
