"""Single-path Pathfinder driver.

Parity target: ``src/singlepath.jl``. The orchestration (optimize → fit →
ELBO-argmax → draws, with a bounded retry loop) matches the reference; the
execution model is one jitted fixed-shape core per
(target, configuration), retried from the host only when a path fails
(failures are rare and data-dependent — exactly the split SURVEY §7
prescribes). All randomness comes from a single ``jax.random`` key, with
per-(try, purpose) ``fold_in`` folding replicating the reference's
determinism contract (``src/multipath.jl:162``, ``src/elbo.jl:2-5``).

Memory model: the jitted core carries only the trajectory trace and compact
per-candidate ELBO statistics — candidate fits are materialized
``elbo_chunk`` at a time inside an early-exiting ``while_loop`` and the winner is rebuilt once
(O(chunk·d·m) live memory instead of O(maxiters·d·m)). The reference's fully
materialized per-point ``fit_distributions`` / per-candidate ELBO draws
(``PathfinderResult`` fields, ``src/singlepath.jl:53-70``) are exposed as
*lazy properties* that rebuild deterministically from the trace and replay
the exact draws from the same fold_in keys.
"""

from __future__ import annotations

import dataclasses
import warnings
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from pathfinder_tpu.models.protocol import LogDensity, as_log_density
from pathfinder_tpu.ops.elbo import (
    ELBOEstimate,
    elbo_and_samples,
    maximize_elbo_chunked,
)
from pathfinder_tpu.ops.lbfgs import (
    OptimizationTrace,
    lbfgs_fits_at,
    lbfgs_history_aux,
    lbfgs_inverse_hessians,
)
from pathfinder_tpu.ops.mvnormal import MvNormal, fit_mvnormal

__all__ = [
    "pathfinder",
    "pathfinder_core",
    "PathfinderResult",
    "PathfinderConfig",
    "uniform_init_sampler",
    "SinglePathState",
]


class PathfinderConfig(NamedTuple):
    """Static configuration of the jitted core (hashable — part of the jit
    cache key). Defaults mirror ``src/Pathfinder.jl:24-27`` and
    ``src/optimize.jl:41``."""

    maxiters: int = 1000
    history_length: int = 6
    ndraws_elbo: int = 5
    ndraws: int = 5
    gtol: float = 1e-8
    # relative objective-progress stop in ulp units (see
    # minimize_lbfgs_trace); <= 0 disables
    ftol: float = 10.0
    epsilon_curvature: float = 1e-12
    max_ls_evals: int = 12
    # sufficient-decrease constant; None = the line search's canonical
    # default (Hager-Zhang δ=0.1 per the reference's LineSearches default,
    # 1e-4 Armijo for the others) — see ops.linesearch.resolve_c1
    c1: Optional[float] = None
    c2: float = 0.9
    fail_on_nonfinite: bool = True
    elbo_chunk: int = 16  # candidates per ELBO chunk (bounds live memory
    # to O(chunk·d·m); chunks past the trajectory end are skipped, so a
    # smaller chunk wastes less work when maxiters >> trajectory length.
    # bench.py's headline passes 8 explicitly)
    # trajectory optimizer (the reference accepts any Optimization.jl
    # optimizer and tests BFGS/ConjugateGradient/NLopt,
    # src/singlepath.jl:120-123, test/optimize.jl:104-135). "lbfgs"
    # (default), "cg" (PR+ nonlinear conjugate gradient,
    # ops/cg.minimize_cg_trace), "bfgs" (dense inverse-Hessian BFGS,
    # ops/bfgs.minimize_bfgs_trace — O(d²), moderate d), "newton"
    # (modified Newton consuming the order-2 hess= capability,
    # ops/newton.minimize_newton_trace — O(d³)/iter), or ANY callable
    # honoring the minimize_*_trace contract (ops/optimizers.py — the
    # user-supplied-optimizer parity path; hashable, reuse one function
    # object across calls for jit-cache stability) — the fit/ELBO
    # stages consume only the emitted trace, so any optimizer that
    # records a trajectory plugs in.
    optimizer: Any = "lbfgs"
    # line search: "hager_zhang" (approximate Wolfe + secant², matching the
    # reference default LineSearches.HagerZhang, src/Pathfinder.jl:25-35),
    # "wolfe" (strong-Wolfe bracket/zoom), or "backtracking" (Armijo-only)
    line_search: str = "hager_zhang"
    # >0: emit a host-callback progress line every N optimizer iterations
    # (the reference's per-iteration ProgressLogging, src/optimize.jl:91-92)
    progress_every: int = 0


def validate_dtype(dtype) -> None:
    """Shared driver-input dtype check: floating only, and warn below 32
    bits: with 8 mantissa bits the curvature pairs s=x_{l+1}-x_l of a
    converging trajectory cancel to noise, so the inverse-Hessian updates
    are rejected and the fits are meaningless."""
    if not jnp.issubdtype(jnp.dtype(dtype), jnp.floating):
        raise ValueError(
            f"dtype must be a floating type; got {jnp.dtype(dtype).name}"
        )
    if jnp.finfo(dtype).bits < 32:
        warnings.warn(
            f"dtype={jnp.dtype(dtype).name} optimization state is almost "
            "always numerically unusable for L-BFGS (curvature pairs lose "
            "all significance); use float32."
        )


class SinglePathState(NamedTuple):
    """Everything the jitted core computes for one path — a pure pytree, so
    it can flow through ``vmap``/``shard_map`` in multipath unchanged."""

    success: jax.Array  # () bool
    key: jax.Array  # the per-try PRNG key (replays all randomness)
    trace: OptimizationTrace  # (trace.point_mask marks the valid points)
    fit_iteration: jax.Array  # () int, 1-based trajectory iteration
    elbo_values: jax.Array  # (maxiters,) per-candidate ELBO (NaN = invalid)
    elbo_se: jax.Array  # (maxiters,)
    fit_distribution: MvNormal  # the ELBO winner
    num_bfgs_updates_rejected: jax.Array  # ()
    draws: jax.Array  # (d, ndraws)
    num_fn_evals: jax.Array  # ()


def _candidate_dists(trace, aux, points, history_length):
    """Fits + means at the given trajectory points (μ = θ + Σ∇logp,
    ``src/mvnormal.jl:17``)."""
    fits = lbfgs_fits_at(aux, points, history_length)
    return jax.vmap(
        lambda c, g, x: fit_mvnormal(x, g, c)
    )(fits, trace.gradients[points], trace.xs[points])


@partial(jax.jit, static_argnames=("target", "config"))
def pathfinder_core(
    key: jax.Array, x0: jax.Array, target: LogDensity, config: PathfinderConfig
) -> SinglePathState:
    """One Pathfinder attempt (parity: ``_pathfinder``,
    ``src/singlepath.jl:285-325``), fully jitted and fixed-shape.

    Pipeline: L-BFGS trajectory (``lax.while_loop``) → chunked batched
    inverse-Hessian fits + ELBO with NaN-skip argmax → winner rebuild +
    draws.
    """
    cfg = config
    key_elbo, key_extra = jax.random.split(key)

    if cfg.maxiters < 1:
        raise ValueError(f"maxiters must be >= 1, got {cfg.maxiters}")
    if cfg.elbo_chunk < 1:
        # a zero/negative chunk would surface as a raw ZeroDivisionError /
        # negative-shape error from inside the trace
        raise ValueError(f"elbo_chunk must be >= 1, got {cfg.elbo_chunk}")
    from pathfinder_tpu.ops.optimizers import resolve_optimizer

    minimize = resolve_optimizer(cfg.optimizer, target, dim=x0.shape[0])

    trace = minimize(
        target.value_and_grad,
        x0,
        maxiters=cfg.maxiters,
        history_length=cfg.history_length,
        gtol=cfg.gtol,
        ftol=cfg.ftol,
        epsilon_curvature=cfg.epsilon_curvature,
        max_ls_evals=cfg.max_ls_evals,
        c1=cfg.c1,
        c2=cfg.c2,
        fail_on_nonfinite=cfg.fail_on_nonfinite,
        progress_every=cfg.progress_every,
        line_search=cfg.line_search,
    )
    aux = lbfgs_history_aux(trace, cfg.epsilon_curvature)
    L = cfg.maxiters

    # candidates are iterations 1..L (skip the initial point,
    # src/singlepath.jl:306-308); fits materialized elbo_chunk at a time
    def make_chunk_dists(cand_idxs):
        points = jnp.clip(cand_idxs + 1, 0, L)
        return _candidate_dists(trace, aux, points, cfg.history_length)

    cand_valid = aux.point_mask[1:]
    best_idx, elbo_values, elbo_se, best_elbo = maximize_elbo_chunked(
        key_elbo,
        target.logp,
        make_chunk_dists,
        num_candidates=L,
        chunk_size=min(cfg.elbo_chunk, L),
        ndraws=cfg.ndraws_elbo,
        valid_mask=cand_valid,
        dtype=trace.xs.dtype,
    )

    n_valid = trace.num_valid - 1
    success = (n_valid > 0) & ~jnp.isnan(best_elbo) & (best_elbo != -jnp.inf)
    fit_iteration = best_idx + 1  # trajectory iteration of the winner

    # rebuild the winner once and replay its ELBO draws from the same key
    # (src/singlepath.jl:227-233: reuse winning draws, top up / truncate)
    fit_dist = jax.tree_util.tree_map(
        lambda leaf: leaf[0], make_chunk_dists(best_idx[None])
    )
    key_winner = jax.random.fold_in(key_elbo, best_idx)
    winner_draws, _ = fit_dist.rand_and_logpdf(key_winner, cfg.ndraws_elbo)
    if cfg.ndraws <= cfg.ndraws_elbo:
        reused = winner_draws[:, : cfg.ndraws]
    else:
        extra = fit_dist.sample(key_extra, cfg.ndraws - cfg.ndraws_elbo)
        reused = jnp.concatenate([winner_draws, extra], axis=1)
    fresh = fit_dist.sample(key_extra, cfg.ndraws)
    draws = jnp.where(success, reused, fresh)

    return SinglePathState(
        success=success,
        key=key,
        trace=trace,
        fit_iteration=fit_iteration,
        elbo_values=elbo_values,
        elbo_se=elbo_se,
        fit_distribution=fit_dist,
        num_bfgs_updates_rejected=aux.num_rejected,
        draws=draws,
        num_fn_evals=trace.num_fn_evals,
    )


def uniform_init_sampler(scale: float = 2.0) -> Callable:
    """IID U[−scale, scale] initial points (parity: ``UniformSampler``,
    ``src/singlepath.jl:332-344``)."""
    if scale <= 0:
        raise ValueError("scale of uniform sampler must be positive.")

    def sampler(key, dim, dtype=jnp.float32):
        return jax.random.uniform(
            key, (dim,), dtype=dtype, minval=-scale, maxval=scale
        )

    return sampler


@dataclasses.dataclass
class PathfinderResult:
    """Single-path result (parity: ``PathfinderResult``,
    ``src/singlepath.jl:53-70``).

    ``optim_trace`` is fixed-shape with a validity count. The reference's
    ``fit_distributions`` (a normal per trajectory point) and
    ``elbo_estimates`` (per-candidate estimates *including draws*) are lazy
    properties: they rebuild from the trace and replay the exact per-
    candidate draws from the stored key — bit-identical to what the core
    used, without retaining O(maxiters·d·ndraws) memory."""

    input: Any
    config: PathfinderConfig
    key: jax.Array
    logp: Callable
    fit_distribution: MvNormal
    draws: jax.Array  # (dim, ndraws)
    fit_distribution_transformed: Any
    draws_transformed: jax.Array
    fit_iteration: int
    num_tries: int
    optim_trace: OptimizationTrace
    elbo_values: jax.Array  # (maxiters,)
    elbo_se: jax.Array  # (maxiters,)
    num_bfgs_updates_rejected: int
    success: bool
    num_fn_evals: int
    state: SinglePathState = None
    # the TransformedLogDensity linking unconstrained → constrained space
    # when the run was transform-aware (BayesModel / transform= kwarg);
    # None for plain unconstrained targets
    transform: Any = None

    @property
    def fit_distributions(self) -> MvNormal:
        """Batched MvNormal over trajectory points 0..maxiters (parity:
        ``PathfinderResult.fit_distributions``), rebuilt on demand."""
        if self.optim_trace.xs.shape[0] == 0:
            raise ValueError(
                "the trajectory trace was dropped (multipathfinder ran "
                "with keep_traces=False), so per-point fits cannot be "
                "rebuilt; re-run with keep_traces=True to use "
                "fit_distributions / elbo_estimates"
            )
        cfg = self.config
        fits, mask, _ = lbfgs_inverse_hessians(
            self.optim_trace,
            history_length=cfg.history_length,
            epsilon_curvature=cfg.epsilon_curvature,
        )
        return jax.vmap(
            lambda c, g, x: fit_mvnormal(x, g, c)
        )(fits, self.optim_trace.gradients, self.optim_trace.xs)

    @property
    def elbo_estimates(self) -> ELBOEstimate:
        """Per-candidate ELBO estimates with draws, replayed exactly
        (parity: ``PathfinderResult.elbo_estimates``)."""
        key_elbo, _ = jax.random.split(self.state.key)
        dists = jax.tree_util.tree_map(
            lambda leaf: leaf[1:], self.fit_distributions
        )
        L = self.config.maxiters
        # chunked like the core's ELBO loop: one wide vmap over all
        # candidates would materialize every per-candidate draw matrix
        # at once
        C = min(self.config.elbo_chunk, L)
        pad = (-L) % C
        idx = jnp.concatenate([jnp.arange(L), jnp.zeros((pad,), jnp.int32)])

        def chunk(ix):
            dst = jax.tree_util.tree_map(lambda l: l[ix], dists)
            return jax.vmap(
                lambda i, d_: elbo_and_samples(
                    jax.random.fold_in(key_elbo, i), self.logp, d_,
                    self.config.ndraws_elbo,
                )
            )(ix, dst)

        est = jax.lax.map(chunk, idx.reshape(-1, C))
        est = jax.tree_util.tree_map(
            lambda l: l.reshape((-1,) + l.shape[2:])[:L], est
        )
        # candidates past the trajectory end replay against stale trace
        # padding and can yield finite nonsense — mask them to NaN so the
        # replayed values agree with the core's stored elbo_values
        # (NaN = invalid) index-for-index
        invalid = jnp.isnan(self.elbo_values)
        nan = jnp.asarray(jnp.nan, est.value.dtype)
        return est._replace(
            value=jnp.where(invalid, nan, est.value),
            std_err=jnp.where(invalid, nan, est.std_err),
        )

    def __repr__(self):
        n = int(self.optim_trace.num_valid) - 1
        try:
            i = self.fit_iteration - 1
            elbo_s = (
                f"{float(self.elbo_values[i]):.2f} ± "
                f"{float(self.elbo_se[i]):.2f}"
            )
        except Exception:
            elbo_s = "n/a"
        return (
            "Single-path Pathfinder result\n"
            f"  tries: {self.num_tries}\n"
            f"  draws: {self.draws.shape[1]}\n"
            f"  fit iteration: {self.fit_iteration} (total: {n})\n"
            f"  fit ELBO: {elbo_s}"
        )


def pathfinder(
    fn,
    *,
    key: jax.Array,
    dim: Optional[int] = None,
    init=None,
    grad=None,
    hess=None,
    ndraws_elbo: int = 5,
    ndraws: Optional[int] = None,
    history_length: int = 6,
    maxiters: int = 1000,
    ntries: int = 1000,
    init_scale: float = 2.0,
    init_sampler: Optional[Callable] = None,
    gtol: float = 1e-8,
    dtype=None,
    core=None,
    progress: bool = False,
    transform=None,
    **config_overrides,
) -> PathfinderResult:
    """Find the ELBO-best multivariate normal approximation along an L-BFGS
    trajectory (parity: ``pathfinder``, ``src/singlepath.jl:85-257``).

    ``fn`` may be a callable ``logp(x)``, a :class:`LogDensity`, any object
    with ``logp``/``dim`` attributes, a
    :class:`~pathfinder_tpu.models.bayes.BayesModel`, or a
    ``TransformedLogDensity``. Keyword parity with the reference:
    ``dim``/``init``, ``init_scale``/``init_sampler``, ``ndraws_elbo``
    (default 5), ``ndraws``, ``history_length`` (default 6), ``ntries``
    (default 1000), ``maxiters`` (default 1000). ``key`` replaces the
    reference's ``rng``. The reference's ``ntasks`` has no analog —
    candidate evaluation is always batched.

    ``transform`` (the Turing-extension analog, ``ext/PathfinderTuringExt.jl``)
    links a constrained-space target: pass a bijector (then ``fn`` is the
    *constrained* log density) or a ``TransformedLogDensity``. Optimization
    runs in unconstrained space with the Jacobian correction; ``init`` /
    ``init_sampler`` operate in *unconstrained* space (use
    ``BayesModel.init_from_params`` / ``init_from_prior`` for the
    constrained-space init strategies); ``result.draws_transformed`` holds
    constrained draws (a named chain dict with per-draw logprior /
    loglikelihood / logjoint when ``fn`` is a model).
    """
    from pathfinder_tpu.integrations.transforms import (
        resolve_transform,
        transformed_outputs,
    )

    if dim is None and init is not None:
        # honor the documented "init or dim" contract for the bijector
        # transform= path too: the dimension is derivable from init
        dim = int(jnp.asarray(init).shape[0])
    target_input, tld = resolve_transform(fn, transform, dim=dim, grad=grad)
    if tld is not None and hess is not None:
        raise ValueError(
            "hess= cannot be combined with a transform: the unconstrained "
            "Hessian needs the bijector chain rule; omit hess= (newton "
            "derives it with jax.hessian of the linked density)."
        )
    # with a transform, grad was consumed (bijector path) or rejected
    target = as_log_density(
        target_input, dim=dim,
        grad=None if tld is not None else grad,
        hess=hess,  # hess+transform already raised above
    )
    if ndraws is None:
        ndraws = ndraws_elbo
    if init is not None:
        init = jnp.asarray(init)
        if not jnp.issubdtype(init.dtype, jnp.floating):
            # plain Python int lists / np int arrays: optimize in float
            init = init.astype(jnp.zeros(0).dtype)
        if dtype is not None:
            init = init.astype(dtype)
        d = init.shape[0]
        if target.dim is not None and target.dim != d:
            # silently keeping the conflict would run the whole pipeline
            # in init's dimension against a target declared differently
            raise ValueError(
                f"init has length {d} but the target's dimension is "
                f"{target.dim}"
            )
    else:
        d = target.dim
        if d is None:
            raise ValueError("An initial point `init` or dimension `dim` must be provided.")
    if target.dim is None:
        target = target.with_dim(d)
    if dtype is None:
        dtype = init.dtype if init is not None else jnp.zeros(0).dtype
    validate_dtype(dtype)
    sampler = init_sampler or uniform_init_sampler(init_scale)

    config = PathfinderConfig(
        maxiters=maxiters,
        history_length=history_length,
        ndraws_elbo=ndraws_elbo,
        ndraws=ndraws,
        gtol=gtol,
        **config_overrides,
    )

    # ``core`` is a SINGLE-path attempt with the pathfinder_core signature
    # ``core(key, x0, target, config) -> SinglePathState`` — NOT the batched
    # executor from make_path_executor (that contract takes (K,)-leading
    # arrays and belongs to multipathfinder).
    core = core or pathfinder_core

    # retry loop (parity: _pathfinder_try_until_succeed,
    # src/singlepath.jl:259-283): host-side, bounded, re-drawing the init
    # point with per-try folded keys.
    import sys as _sys

    itry = 1
    if progress:
        print("Optimizing (try 1)", file=_sys.stderr)
    key_try = jax.random.fold_in(key, 0)
    x0 = init if init is not None else sampler(
        jax.random.fold_in(key_try, 1), d, dtype
    )
    state = core(key_try, x0, target, config)
    while not bool(state.success) and itry < ntries:
        itry += 1
        if progress:
            print(f"Optimizing (try {itry})", file=_sys.stderr)
        key_try = jax.random.fold_in(key, itry - 1)
        x0 = sampler(jax.random.fold_in(key_try, 1), d, dtype)
        state = core(key_try, x0, target, config)

    success = bool(state.success)
    if not success:
        warnings.warn(
            f"Pathfinder failed after {itry} tries. Increase `ntries`, inspect "
            "the model for numerical instability, or provide a more suitable "
            "`init_sampler`."
        )
    nrej = int(state.num_bfgs_updates_rejected)
    if nrej > 0:
        # updates happen per STEP: a trajectory of n points has n-1 of them
        total = int(state.trace.num_valid) - 1
        perc = round(nrej * 100.0 / max(total, 1), 1)
        warnings.warn(
            f"{nrej} ({perc}%) updates to the inverse Hessian estimate were "
            "rejected to keep it positive definite."
        )

    draws_t, fit_t = transformed_outputs(
        tld, fn, state.draws, state.fit_distribution
    )
    return PathfinderResult(
        input=fn,
        config=config,
        key=key,
        logp=target.logp,
        fit_distribution=state.fit_distribution,
        draws=state.draws,
        fit_distribution_transformed=fit_t,
        draws_transformed=draws_t,
        fit_iteration=int(state.fit_iteration),
        num_tries=itry,
        optim_trace=state.trace,
        elbo_values=state.elbo_values,
        elbo_se=state.elbo_se,
        num_bfgs_updates_rejected=nrej,
        success=success,
        num_fn_evals=int(state.num_fn_evals),
        state=state,
        transform=tld,
    )
