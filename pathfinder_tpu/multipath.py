"""Multi-path Pathfinder: batched paths → mixture → PSIS → resampling.

Parity target: ``src/multipath.jl`` + ``src/resample.jl``. The reference
fans K single-path runs out over task chunks (``src/multipath.jl:190-204``);
here all K paths run as one batched program — ``vmap`` within a chip,
optionally ``shard_map`` over a device mesh (see
``pathfinder_tpu.parallel.sharding``). Per-path retries happen in bounded
host-driven rounds re-running only failed lanes' keys, mirroring ``ntries``
semantics without serializing (SURVEY §7 hard-part 5).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pathfinder_tpu.models.protocol import LogDensity, as_log_density
from pathfinder_tpu.ops.mvnormal import MvNormal, UniformMixture
from pathfinder_tpu.ops.woodbury import WoodburyPDMat
from pathfinder_tpu.ops.psis import PSISResult, psis
from pathfinder_tpu.ops.resample import resample_draws
from pathfinder_tpu.parallel import sharding as _sharding
from pathfinder_tpu.parallel.sharding import (
    chunk_launches,
    make_path_executor,
    pad_paths,
)
from pathfinder_tpu.singlepath import (
    PathfinderConfig,
    PathfinderResult,
    SinglePathState,
    uniform_init_sampler,
    validate_dtype,
)

__all__ = [
    "multipathfinder",
    "MultiPathfinderResult",
    "resample",
    "laplace_resample",
]


def _khat_remedy_hint(tried_auto: bool = False, tried_laplace: bool = False) -> str:
    """One-line actionable remedy hint for a bad/very-bad Pareto-k̂ verdict.

    The remedies are the repo's own measured ones (see
    ``docs/examples/resampling.md``): optimizer
    competition (``optimizer="auto"``), the Laplace covariance correction
    (``auto_laplace=True`` / :func:`laplace_resample`), and — for funnel-like
    geometry where importance sampling is measured hopeless — warm-started
    sampling via ``integrations.nuts.warm_start_chains``."""
    remedies = []
    if not tried_auto:
        remedies.append("optimizer='auto' (k-hat-arbitrated optimizer competition)")
    if not tried_laplace:
        remedies.append(
            "laplace_resample(result, ndraws)"
            + ("" if tried_auto else " or auto_laplace=True")
            + " (curvature-corrected covariances)"
        )
    remedies.append(
        "for funnel-like geometry use warm_start_chains + NUTS instead of "
        "importance sampling"
    )
    return (
        "measured remedies: " + "; ".join(remedies)
        + " — see docs/examples/resampling.md"
    )


def _maybe_warn_bad_khat(
    psis_result: Optional[PSISResult],
    *,
    tried_auto: bool = False,
    tried_laplace: bool = False,
) -> None:
    """Warn with an actionable hint when the PSIS verdict is bad/very bad
    (k̂ > 0.7, the reference's thresholds ``src/multipath.jl:54-63``).
    Beyond reference: the reference only *prints* the verdict; here the
    measured remedies are surfaced where the user will see them."""
    if psis_result is None:
        return
    verdict = psis_result.diagnosis
    if verdict not in ("bad", "very bad"):
        return
    k = float(psis_result.pareto_shape)
    warnings.warn(
        f"Pareto k-hat = {k:.2f} ({verdict}): importance weights are "
        "unreliable and resampled draws may misrepresent the target; "
        + _khat_remedy_hint(tried_auto=tried_auto, tried_laplace=tried_laplace)
    )


def _select_component_fits(states: SinglePathState) -> MvNormal:
    """Per-path ELBO-winning fit distribution (batched over paths) — the
    core already selects its winner, so this is just the field."""
    return states.fit_distribution


def _slim_traces(states: SinglePathState) -> SinglePathState:
    """Drop the per-path trajectory arrays (``keep_traces=False``), keeping
    the scalar trace diagnostics (``num_valid``, eval/rejection counts).

    The trace is the dominant per-path device-memory consumer — xs +
    gradients are 2·(maxiters+1)·d floats ≈ 520 KB/path at the
    d=1000/maxiters=64 headline vs ~100 KB for everything else — and
    nothing pooled (mixture, PSIS, resample, laplace_resample, warm starts,
    serialization) reads it. Applied per launch *inside* the chunked
    executor, it caps peak device memory at one chunk's trace + the slim
    accumulated states. Trajectory slices become zero-length, so
    trace-dependent lazy rebuilds (``fit_distributions``/``elbo_estimates``)
    raise with guidance."""
    tr = states.trace
    # batched over paths: trajectory axis is axis 1
    slim = tr._replace(
        xs=tr.xs[:, :0],
        log_densities=tr.log_densities[:, :0],
        gradients=tr.gradients[:, :0],
    )
    return states._replace(trace=slim)


@jax.jit
def _log_importance_ratios_fit(components: MvNormal, draws_knd: jax.Array):
    """logq of each draw under *its own* component (not the mixture!) —
    reference semantics at ``src/resample.jl:81-89``."""
    return jax.vmap(lambda c, dk: c.logpdf(dk.T))(
        components, draws_knd
    )


@jax.jit
def _log_importance_ratios_mixture(components: MvNormal, draws_knd: jax.Array):
    """logq of each draw under the full uniform mixture: ``logsumexp_k'
    logq_k'(x) − log K``. The proposal the pooled draws are *actually*
    distributed as, so the importance weights have provably no more
    variance than the own-component ratios (the balance heuristic /
    mixture-IS estimator). The reference uses own-component ratios only
    (``src/resample.jl:86-89``) — K·N component logpdfs; the mixture needs
    K²·N, sequentially prohibitive but one batched O(K²·N·d·m) matmul
    tower. Opt-in via ``importance_denominator="mixture"``."""
    K, N, d = draws_knd.shape
    flat = draws_knd.reshape(K * N, d)
    logq_all = jax.vmap(
        lambda c: c.logpdf(flat.T)
    )(components)  # (K components, K*N draws)
    logq_mix = jax.scipy.special.logsumexp(logq_all, axis=0) - jnp.log(K)
    return logq_mix.reshape(K, N)


@jax.jit
def _log_ratios_component_block(components: MvNormal, draws_knd, logp_knd):
    """Own-component log ratios for one path block (jitted once per block
    shape; sequential-launch companion to :func:`chunk_launches`)."""
    log_q = _log_importance_ratios_fit(components, draws_knd)
    return (logp_knd - log_q).reshape(-1)


def _compute_psis_result(
    logp: Callable, components: MvNormal, draws_knd: jax.Array,
    denominator: str = "component",
    chunk: Optional[int] = None,
) -> PSISResult:
    """Parity: ``_compute_psis_result`` (``src/resample.jl:74-95``).

    ``denominator="component"`` reproduces the reference's own-component
    log-ratios; ``"mixture"`` uses the full-mixture logpdf (lower-variance
    weights, better Pareto-k̂ — see
    :func:`_log_importance_ratios_mixture`).

    ``chunk`` (own-component denominator only) computes the per-path log
    ratios in sequential launches of one fixed-shape ``chunk``-path
    program — the tail analog of ``max_paths_per_launch``: at serving-
    scale K one monolithic ratio program holds every path's draws and
    logp intermediates at once. The K·N pooled scalars then feed ONE tiny
    ``psis`` fit, identical to the unchunked result (ratios are
    elementwise per path; only concatenation order matters, and blocks
    preserve component-major order). The mixture denominator needs every
    component against every draw (K²·N) and is not chunked."""
    log_p_fn = jax.vmap(jax.vmap(logp))  # NOT re-wrapped in jit here: a
    # fresh jit per call would split the compile cache
    if denominator == "component":
        K = draws_knd.shape[0]
        if chunk is not None and 0 < chunk < K:
            n_blocks = -(-K // chunk)

            def block(b):
                lo, hi = b * chunk, min((b + 1) * chunk, K)
                # pad ONLY the final partial block (a chunk-sized copy);
                # padding the whole tree would transiently double the
                # per-path state — the thing chunking exists to avoid
                def take(leaf):
                    part = leaf[lo:hi]
                    if hi - lo == chunk:
                        return part
                    fill = jnp.broadcast_to(
                        part[:1], (chunk - (hi - lo),) + part.shape[1:]
                    )
                    return jnp.concatenate([part, fill])

                comps_b = jax.tree_util.tree_map(take, components)
                dk_b = take(draws_knd)
                return _log_ratios_component_block(
                    comps_b, dk_b, log_p_fn(dk_b)
                )

            ratios = jnp.concatenate([block(b) for b in range(n_blocks)])
            return psis(ratios[: K * draws_knd.shape[1]])
        log_q = _log_importance_ratios_fit(components, draws_knd)
    elif denominator == "mixture":
        log_q = _log_importance_ratios_mixture(
            components, draws_knd
        )
    else:
        raise ValueError(f"unknown importance_denominator {denominator!r}")
    log_p = log_p_fn(draws_knd)  # (K, N)
    log_ratios = (log_p - log_q).reshape(-1)  # component-major
    return psis(log_ratios)


@dataclasses.dataclass
class MultiPathfinderResult:
    """Parity: ``MultiPathfinderResult`` (``src/multipath.jl:31-44``)."""

    input: Any
    config: PathfinderConfig
    key: jax.Array
    logp: Callable
    fit_distribution: UniformMixture
    draws: jax.Array  # (dim, ndraws)
    draw_component_ids: jax.Array  # (ndraws,)
    fit_distribution_transformed: Any
    draws_transformed: jax.Array
    states: SinglePathState  # batched over paths
    psis_result: Optional[PSISResult]
    num_tries: jax.Array  # (K,) tries per path
    draws_per_component: jax.Array  # (K, N, d) pooled candidate draws
    target: LogDensity = None
    transform: Any = None  # integrations hook (Turing-ext analog)
    # which log-ratio denominator produced psis_result ("component" or
    # "mixture") — lets resample reuse or recompute correctly
    importance_denominator: str = "component"
    # the launch cap the run used (None = single program); resample /
    # laplace_resample reuse it so PSIS recomputes on a serving-scale
    # result stay block-wise instead of compiling one monolithic program
    max_paths_per_launch: Optional[int] = None

    @property
    def nruns(self) -> int:
        return self.states.draws.shape[0]

    def path_result(self, k: int) -> PathfinderResult:
        """Materialize the k-th path's :class:`PathfinderResult` view
        (parity: ``pathfinder_results`` field; per-path ``draws_transformed``
        like ``ext/PathfinderTuringExt.jl:269-277``)."""
        from pathfinder_tpu.integrations.transforms import transformed_outputs

        st = jax.tree_util.tree_map(lambda leaf: leaf[k], self.states)
        draws_t, fit_t = transformed_outputs(
            self.transform, self.input, st.draws, st.fit_distribution
        )
        return PathfinderResult(
            input=self.input,
            config=self.config,
            key=self.key,
            logp=self.logp,
            fit_distribution=st.fit_distribution,
            draws=st.draws,
            fit_distribution_transformed=fit_t,
            draws_transformed=draws_t,
            fit_iteration=int(st.fit_iteration),
            num_tries=int(self.num_tries[k]),
            optim_trace=st.trace,
            elbo_values=st.elbo_values,
            elbo_se=st.elbo_se,
            num_bfgs_updates_rejected=int(st.num_bfgs_updates_rejected),
            success=bool(st.success),
            num_fn_evals=int(st.num_fn_evals),
            state=st,
            transform=self.transform,
        )

    @property
    def pathfinder_results(self):
        return [self.path_result(k) for k in range(self.nruns)]

    def __repr__(self):
        out = (
            "Multi-path Pathfinder result\n"
            f"  runs: {self.nruns}\n"
            f"  draws: {self.draws.shape[1]}"
        )
        if self.psis_result is not None:
            k = float(self.psis_result.pareto_shape)
            verdict = self.psis_result.diagnosis
            out += f"\n  Pareto shape diagnostic: {k:.2f} ({verdict})"
            if verdict in ("bad", "very bad"):
                out += (
                    "\n  hint: k-hat > 0.7 — try optimizer='auto', "
                    "laplace_resample, or warm_start_chains "
                    "(docs/examples/resampling.md)"
                )
        return out


def multipathfinder(
    fn,
    ndraws: int,
    *,
    key: jax.Array,
    nruns: Optional[int] = None,
    init=None,
    dim: Optional[int] = None,
    grad=None,
    hess=None,
    ndraws_elbo: int = 5,
    ndraws_per_run: Optional[int] = None,
    importance: bool = True,
    importance_denominator: str = "component",
    history_length: int = 6,
    maxiters: int = 1000,
    ntries: int = 1000,
    init_scale: float = 2.0,
    init_sampler: Optional[Callable] = None,
    gtol: float = 1e-8,
    mesh=None,
    max_paths_per_launch: Optional[int] = None,
    keep_traces: bool = True,
    offload_launches: Optional[bool] = None,
    dtype=None,
    progress: bool = False,
    transform=None,
    **config_overrides,
) -> MultiPathfinderResult:
    """Run Pathfinder from ``nruns`` starting points, mix, and importance-
    resample (parity: ``multipathfinder``, ``src/multipath.jl:118-245``).

    Keyword parity: ``init`` (array ``(nruns, dim)``) or ``nruns`` + ``dim``;
    ``ndraws_per_run`` defaults to ``max(ndraws_elbo, ceil(ndraws / nruns))``
    (``src/multipath.jl:138``); ``importance=True`` enables PSIS. ``mesh``
    shards the paths axis across devices. ``max_paths_per_launch`` caps the
    lane count of any single compiled program: larger batches run as
    sequential launches of one fixed-shape program. Keys depend only on
    the path id, so no randomness or algorithmic decision changes; a
    fixed cap is fully deterministic, and different caps agree up to
    XLA's per-batch-size rounding on the CPU (last few ulps); on a GPU
    the batch width selects other compiled code and trajectories can
    diverge (see :func:`pathfinder_tpu.parallel.sharding.chunk_launches`
    and the README's determinism contract). Default
    ``None`` resolves transparently: one program up to
    ``sharding.SINGLE_PROGRAM_MAX_K`` (6144) lanes, sequential
    ``sharding.DEFAULT_LAUNCH_CAP``-lane (4096) launches past it —
    serving-scale ``nruns`` just works; pass a cap ≥ ``nruns`` to force a
    single program. ``keep_traces=False`` drops each path's trajectory
    arrays after its launch (the dominant per-path device-memory cost; see
    :func:`_slim_traces`) — combined with ``max_paths_per_launch`` this is
    the serving-scale configuration. ``offload_launches`` streams each
    chunk's (slim) output to host RAM as it completes, so per-path state
    never accumulates in device memory — host memory becomes the
    paths-axis ceiling. Default ``None`` auto-offloads when chunked
    launches would accumulate more than a fixed fraction of each device's
    memory limit (see :func:`pathfinder_tpu.parallel.sharding.
    chunk_launches`) — it never engages for un-chunked runs or on a
    backend that reports no limit; ``True`` always offloads, including a
    single launch. Values are bit-identical either way (device→host
    round trips preserve bits; the PSIS tail and resample then feed one
    path block at a time from host, and when offload engages
    ``result.states`` holds numpy leaves). Draws, the mixture, PSIS,
    ``resample``/``laplace_resample``, warm starts, and serialization are
    unaffected (bit-identical); only per-path ``fit_distributions`` /
    ``elbo_estimates`` rebuilds become unavailable. The reference's
    ``ntasks``/``ntasks_per_run`` have no analog — everything is batched.

    ``fn`` may also be a ``BayesModel`` or ``TransformedLogDensity``, or
    ``transform=`` a bijector/``TransformedLogDensity`` (see
    :func:`pathfinder`); then optimization runs in unconstrained space and
    ``draws_transformed`` (for the pooled result and every per-path view)
    holds constrained draws, re-derived automatically by :func:`resample`
    (parity: ``ext/PathfinderTuringExt.jl:246-286``).

    ``optimizer="auto"`` (beyond-reference) runs the full pipeline under
    each optimizer in ``auto_optimizers`` (default ``("lbfgs", "cg")``;
    any mix of lbfgs/cg/bfgs/newton names and custom trace-contract
    callables, see ``ops/optimizers.py``) and returns the result with the
    lower Pareto-k̂ — which optimizer produces better-located components
    is target-dependent while the ELBO cannot tell (measured; see
    ``docs/examples/resampling.md``). A NaN k̂ with near-uniform weights
    (ESS ≈ N — a perfect fit's zero-variance tail) ranks best; other NaN
    k̂s rank last. Candidates run in ``auto_optimizers`` order and stop
    early as soon as one reaches k̂ < ``auto_khat_early_exit`` (default
    0.7, the reference's "ok" verdict boundary, ``src/multipath.jl:54-63``;
    pass ``None`` to always run every candidate) — so on targets where the
    first optimizer already fits well, auto costs ONE run, not the sum.
    Worst case (no candidate under the threshold) = one full run per
    optimizer. Requires ``importance=True``. ``auto_laplace=True`` (or
    ``"diag"``/``"full"``) additionally applies :func:`laplace_resample`
    to the winner when no candidate reached the threshold, keeping the
    correction only if the k̂ improves — the cheapest escalation.
    """
    from pathfinder_tpu.ops.optimizers import OPTIMIZERS as _KNOWN_OPTS

    # internal: auto-mode candidate sub-runs suppress the bad-k̂ remedy
    # hint — only the final (winning) result should warn the user
    suppress_khat_hint = config_overrides.pop("_suppress_khat_hint", False)
    auto_set = config_overrides.pop("auto_optimizers", None)
    _sentinel = object()
    auto_khat_early_exit = config_overrides.pop(
        "auto_khat_early_exit", _sentinel
    )
    auto_laplace = config_overrides.pop("auto_laplace", False)
    if auto_set is not None and config_overrides.get("optimizer") != "auto":
        raise ValueError(
            "auto_optimizers requires optimizer='auto' (it names the "
            "candidates the auto mode runs)"
        )
    if auto_laplace and config_overrides.get("optimizer") != "auto":
        raise ValueError(
            "auto_laplace requires optimizer='auto' (it extends the auto "
            "mode's k̂ arbitration; call laplace_resample directly on a "
            "finished result otherwise)"
        )
    if auto_laplace is True:
        auto_laplace = "diag"
    if auto_laplace not in (False, "diag", "full"):
        raise ValueError(
            f"auto_laplace must be False, True, 'diag', or 'full'; got "
            f"{auto_laplace!r}"
        )
    if (
        auto_khat_early_exit is not _sentinel
        and config_overrides.get("optimizer") != "auto"
    ):
        raise ValueError(
            "auto_khat_early_exit requires optimizer='auto' (it bounds "
            "the auto mode's candidate competition)"
        )
    if auto_khat_early_exit is _sentinel:
        auto_khat_early_exit = 0.7  # the "ok" verdict boundary
    elif auto_khat_early_exit is not None:
        # fail fast — a bad threshold discovered after the first full
        # candidate run would waste the whole pipeline
        auto_khat_early_exit = float(auto_khat_early_exit)
    if config_overrides.get("optimizer") == "auto":
        if auto_set is None:
            auto_set = ("lbfgs", "cg")
        elif isinstance(auto_set, str):
            # a bare string would iterate per character
            auto_set = (auto_set,)
        elif callable(auto_set):
            auto_set = (auto_set,)
        else:
            auto_set = tuple(auto_set)
        if not auto_set:
            raise ValueError("auto_optimizers must name at least one optimizer")
        bad = [
            o for o in auto_set
            if not (o in _KNOWN_OPTS or (callable(o) and not isinstance(o, str)))
        ]
        if bad:
            # validate up front — a typo discovered inside the Nth
            # sub-run would waste every earlier full pipeline
            raise ValueError(
                f"unknown auto_optimizers entries {bad}; choose from "
                f"{tuple(_KNOWN_OPTS)} or pass callables with the "
                "minimize_*_trace contract"
            )
        # Run both trajectory optimizers and let the Pareto-k̂ diagnostic
        # arbitrate (k̂ as a VI fit-quality diagnostic, Yao et al. 2018).
        # Measured motivation: which optimizer yields better-located
        # components is target-dependent (k̂ 2.02 lbfgs vs 0.99 cg on the
        # d=1000 hierarchical bench target; 0.61 vs 4.56 on the 101-D
        # funnel) while the ELBO cannot discriminate — see
        # docs/examples/resampling.md. Costs two full runs.
        if not importance:
            raise ValueError(
                "optimizer='auto' selects by Pareto-k̂ and therefore "
                "requires importance=True"
            )
        shared = dict(
            key=key, nruns=nruns, init=init, dim=dim, grad=grad, hess=hess,
            ndraws_elbo=ndraws_elbo, ndraws_per_run=ndraws_per_run,
            importance=importance,
            importance_denominator=importance_denominator,
            history_length=history_length, maxiters=maxiters,
            ntries=ntries, init_scale=init_scale,
            init_sampler=init_sampler, gtol=gtol, mesh=mesh,
            max_paths_per_launch=max_paths_per_launch,
            keep_traces=keep_traces, dtype=dtype,
            progress=progress, transform=transform,
        )
        def _khat(r):
            k = float(r.psis_result.pareto_shape)
            if k == k:
                return k
            # NaN k̂ ("not computed") is ambiguous: a zero-variance weight
            # tail from a PERFECT fit (every weight ≈ 1/N, ESS ≈ N) is the
            # best possible IS outcome and ranks first (-inf; ties break
            # by auto_optimizers order). But psis() ALSO returns uniform
            # weights when every log ratio was non-finite (the
            # all-degenerate fallback) — a completely broken candidate.
            # Require healthy evidence (all paths succeeded, finite
            # draws) before awarding the perfect-fit rank; any other NaN
            # ranks last.
            ess_frac = float(r.psis_result.ess) / r.psis_result.weights.shape[0]
            healthy = bool(
                np.all(np.asarray(r.states.success))
            ) and bool(np.isfinite(np.asarray(r.draws)).all())
            return (
                float("-inf") if (ess_frac >= 0.99 and healthy)
                else float("inf")
            )

        candidates = {}
        for opt in auto_set:
            r = multipathfinder(
                fn, ndraws, **shared,
                **{
                    **config_overrides,
                    "optimizer": opt,
                    "_suppress_khat_hint": True,
                },
            )
            candidates[opt] = r
            # early exit: a candidate at "ok" or
            # better ends the competition — later candidates could at
            # best improve an already-acceptable fit, and each one costs
            # a full pipeline run
            if (
                auto_khat_early_exit is not None
                and _khat(r) < auto_khat_early_exit
            ):
                break
        winner = candidates[
            min(candidates, key=lambda o: _khat(candidates[o]))
        ]
        if auto_laplace:
            # opt-in escalation: when no
            # candidate reached an acceptable k̂, the Laplace covariance
            # correction at the winner's own component means is far
            # cheaper than another full candidate run (one batched
            # Hessian program vs trajectory+ELBO+PSIS) and closed the
            # d=1000 headline gap (cg 1.60 → 1.01–1.06). Kept only if
            # the diagnostic actually improves — the correction can be
            # a slight negative when the fits already match the local
            # curvature (see laplace_resample's docstring).
            trigger = (
                auto_khat_early_exit
                if auto_khat_early_exit is not None
                else 0.7
            )
            if _khat(winner) >= trigger:
                corrected = laplace_resample(
                    winner, ndraws, method=auto_laplace
                )
                if _khat(corrected) < _khat(winner):
                    winner = corrected
        if not suppress_khat_hint:
            _maybe_warn_bad_khat(
                winner.psis_result,
                tried_auto=True,
                tried_laplace=bool(auto_laplace),
            )
        return winner

    from pathfinder_tpu.integrations.transforms import (
        resolve_transform,
        transformed_outputs,
    )

    if dim is None and init is not None:
        # honor the documented "init or dim" contract for the bijector
        # transform= path too: the dimension is derivable from init
        _init_arr = jnp.asarray(init)
        if _init_arr.ndim == 2:
            dim = int(_init_arr.shape[1])
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

    if init is not None:
        init = jnp.asarray(init)
        if not jnp.issubdtype(init.dtype, jnp.floating):
            # plain Python int lists / np int arrays: optimize in float
            init = init.astype(jnp.zeros(0).dtype)
        if init.ndim != 2:
            raise ValueError("init must have shape (nruns, dim)")
        if nruns is not None and nruns != init.shape[0]:
            raise ValueError(
                f"nruns={nruns} conflicts with init's {init.shape[0]} rows"
            )
        nruns = init.shape[0]
        d = init.shape[1]
        if target.dim is not None and target.dim != d:
            raise ValueError(
                f"init rows have length {d} but the target's dimension is "
                f"{target.dim}"
            )
    else:
        if nruns is None or nruns <= 0:
            raise ValueError(
                "A positive `nruns` must be set or `init` must be provided."
            )
        d = target.dim
        if d is None:
            raise ValueError("`dim` must be provided when `fn` has no dimension.")
    if target.dim is None:
        target = target.with_dim(d)
    if dtype is None:
        dtype = init.dtype if init is not None else jnp.zeros(0).dtype
    validate_dtype(dtype)
    sampler = init_sampler or uniform_init_sampler(init_scale)

    if ndraws_per_run is None:
        ndraws_per_run = max(ndraws_elbo, -(-ndraws // max(nruns, 1)))
    if ndraws > ndraws_per_run * nruns:
        warnings.warn(
            "More draws requested than total number of draws across replicas. "
            "Draws will not be unique."
        )

    config = PathfinderConfig(
        maxiters=maxiters,
        history_length=history_length,
        ndraws_elbo=ndraws_elbo,
        ndraws=ndraws_per_run,
        gtol=gtol,
        **config_overrides,
    )

    K = pad_paths(nruns, mesh)
    # chunk the path axis over sequential launches of one fixed-shape
    # program when K exceeds the cap (see chunk_launches); keys depend
    # only on (path id, round), so no sampled randomness changes.
    # Transparent default: past the single-program ceiling, chunk
    # automatically so serving-scale nruns just works (constants:
    # parallel/sharding.py)
    if max_paths_per_launch is None and K > _sharding.SINGLE_PROGRAM_MAX_K:
        max_paths_per_launch = _sharding.DEFAULT_LAUNCH_CAP
    inner_executor = make_path_executor(mesh)
    if not keep_traces:
        # slim each launch's output so chunked launches free the previous
        # chunk's trajectory buffers before the next one runs (the whole
        # point of keep_traces=False — see _slim_traces)
        base_executor = inner_executor

        def inner_executor(keys, x0s, target, config):
            return _slim_traces(base_executor(keys, x0s, target, config))

    executor = chunk_launches(
        inner_executor, max_paths_per_launch, mesh, offload=offload_launches
    )

    def path_keys(path_ids, round_idx: int):
        # THE key-derivation rule: fold (path id, round) into the master
        # key. Round 0 and the retry rounds both call this (the
        # determinism contract "keys depend only on (path id, round)"
        # must have one source of truth).
        return jax.vmap(
            lambda i: jax.random.fold_in(
                jax.random.fold_in(key, i), round_idx
            )
        )(path_ids)

    def path_inits(keys, round_idx: int):
        if init is not None and round_idx == 0:
            pad = jnp.zeros((K - nruns, d), init.dtype)
            return jnp.concatenate([init, pad], axis=0).astype(dtype)
        return jax.vmap(lambda k: sampler(jax.random.fold_in(k, 1), d, dtype))(
            keys
        )

    reporter = None
    if progress:
        from pathfinder_tpu.utils.progress import ThrottledProgress

        reporter = ThrottledProgress(nruns, name="Multi-path Pathfinder")

    # round 0 for all paths, then bounded retry rounds for the failed lanes
    # only (parity: per-path ntries, src/singlepath.jl:259-283). Retry
    # batches are compacted to the failed lanes, padded to a power of two so
    # at most log2(K) retry shapes ever compile; keys depend only on
    # (path id, round), so results are independent of batch layout.
    keys0 = path_keys(jnp.arange(K), 0)
    states = executor(keys0, path_inits(keys0, 0), target, config)
    num_tries = np.ones(K, dtype=np.int64)
    # retries reuse the sharded executor: failed lanes are compacted, then
    # padded to a power of two (so at most log2(K) retry shapes compile) AND
    # to a mesh-divisible size, so a large failed batch on a 1000-path
    # sharded run keeps riding the mesh instead of serializing onto one chip.
    # Keys depend only on (path id, round), so results are independent of
    # batch layout and of the mesh.
    rounds = 1
    while rounds < ntries:
        failed = np.array(~states.success)  # writable host copy
        failed[nruns:] = False  # ignore padding lanes
        if reporter is not None:
            reporter.update(
                nruns - int(failed.sum()), extra=f"(round {rounds})"
            )
        if not failed.any():
            break
        fidx = np.nonzero(failed)[0]
        B = 1 << max(0, int(np.ceil(np.log2(len(fidx)))))
        B = pad_paths(B, mesh)
        pad_idx = np.concatenate([fidx, np.full(B - len(fidx), fidx[0])])
        sel = jnp.asarray(pad_idx)
        keys_r = path_keys(sel, rounds)
        x0s_r = path_inits(keys_r, rounds)
        retry = executor(keys_r, x0s_r, target, config)
        retry = jax.tree_util.tree_map(lambda leaf: leaf[: len(fidx)], retry)

        def merge(old, new):
            if isinstance(old, np.ndarray):
                # offloaded launches accumulate on host; update the rows
                # in place (the buffers are freshly allocated by
                # chunk_launches, so this run exclusively owns them —
                # re-uploading or copying K-scale state each retry round
                # would defeat the offload)
                old[fidx] = np.asarray(new)
                return old
            return old.at[jnp.asarray(fidx)].set(new)

        states = jax.tree_util.tree_map(merge, states, retry)
        num_tries[failed] += 1
        rounds += 1

    if reporter is not None:
        reporter.update(nruns - int(np.sum(~np.asarray(states.success[:nruns]))))
        reporter.close()

    # un-pad
    if K != nruns:
        states = jax.tree_util.tree_map(lambda leaf: leaf[:nruns], states)
        num_tries = num_tries[:nruns]

    n_failed = int(np.sum(~np.asarray(states.success)))
    if n_failed:
        warnings.warn(
            f"{n_failed} of {nruns} Pathfinder runs failed after {ntries} "
            "tries; their fits may contaminate the mixture."
        )

    components = _select_component_fits(states)
    mixture = UniformMixture(components)
    # host-offloaded states stay on host: np.swapaxes is a view, and the
    # block-chunked PSIS tail + host-pool resample transfer one block at
    # a time (jnp.swapaxes here would re-upload the whole K-scale pool)
    xp = np if isinstance(states.draws, np.ndarray) else jnp
    draws_knd = xp.swapaxes(states.draws, 1, 2)  # (K, N, d)

    psis_result = (
        _compute_psis_result(
            target.logp, components, draws_knd,
            denominator=importance_denominator,
            # the tail analog of chunked launches: one fixed-shape
            # ratio program per path block (component denominator only)
            chunk=(
                max_paths_per_launch
                if importance_denominator == "component"
                else None
            ),
        )
        if importance
        else None
    )
    key_resample = jax.random.fold_in(key, 0x5E5A)
    draws, component_ids = resample_draws(
        key_resample, draws_knd, psis_result, ndraws
    )
    if not suppress_khat_hint:
        _maybe_warn_bad_khat(psis_result)

    draws_t, fit_t = transformed_outputs(tld, fn, draws, mixture)
    return MultiPathfinderResult(
        input=fn,
        config=config,
        key=key,
        logp=target.logp,
        fit_distribution=mixture,
        draws=draws,
        draw_component_ids=component_ids,
        fit_distribution_transformed=fit_t,
        draws_transformed=draws_t,
        states=states,
        psis_result=psis_result,
        num_tries=jnp.asarray(num_tries),
        draws_per_component=draws_knd,
        target=target,
        transform=tld,
        importance_denominator=importance_denominator,
        max_paths_per_launch=max_paths_per_launch,
    )


def resample(
    result: MultiPathfinderResult,
    ndraws: int,
    *,
    key: Optional[jax.Array] = None,
    replace: bool = True,
    importance: bool = True,
    importance_denominator: Optional[str] = None,
    ndraws_per_run: Optional[int] = None,
) -> MultiPathfinderResult:
    """Re-resample a finished result without re-optimizing (parity:
    ``resample``, ``src/resample.jl:20-46``).

    Reuses stored per-path draws (and the stored PSIS result) unless
    ``ndraws_per_run`` requests fresh draws from each component; recomputes
    PSIS when needed; preserves every field other than the draws,
    component ids, transformed draws, candidate pool, and ``psis_result``
    — which, matching the reference (``src/resample.jl:119-137`` and its
    docstring), reflects the *new* draws: ``importance=False`` stores
    ``psis_result=None`` even when a stored diagnostic existed. The stored PSIS result is tagged with
    the denominator that produced it (``result.importance_denominator``):
    leaving ``importance_denominator=None`` reuses it as-is, and an
    explicit value only triggers a recompute when it differs from the tag.
    """
    if key is None:
        key = jax.random.fold_in(result.key, 0x7E5A)
    components = result.fit_distribution.components
    stored_denom = (
        getattr(result, "importance_denominator", None) or "component"
    )
    effective_denom = importance_denominator or stored_denom

    if ndraws_per_run is None:
        draws_knd = result.draws_per_component
        psis_stored = result.psis_result
        if effective_denom != stored_denom:
            psis_stored = None  # recompute with the requested ratios
    else:
        key, sub = jax.random.split(key)
        K = components.mean.shape[0]
        keys = jax.random.split(sub, K)
        draws_knd = jax.vmap(
            lambda c, k: c.sample(k, ndraws_per_run).T
        )(components, keys)
        psis_stored = None

    if importance:
        psis_used = (
            psis_stored
            if psis_stored is not None
            else _compute_psis_result(
                result.logp, components, draws_knd,
                denominator=effective_denom,
                chunk=getattr(result, "max_paths_per_launch", None),
            )
        )
    else:
        psis_used = None

    draws, component_ids = resample_draws(
        key, draws_knd, psis_used, ndraws, replace=replace
    )
    # re-derive the constrained view on the fresh draws (parity:
    # _rebuild_draws_transformed hook, src/resample.jl:112 +
    # ext/PathfinderTuringExt.jl:280-286)
    from pathfinder_tpu.integrations.transforms import transformed_outputs

    draws_transformed, _ = transformed_outputs(
        result.transform, result.input, draws, result.fit_distribution
    )
    return dataclasses.replace(
        result,
        draws=draws,
        draw_component_ids=component_ids,
        draws_transformed=draws_transformed,
        psis_result=psis_used,
        # the candidate pool the (possibly fresh) psis_result was computed
        # on — a later resample() on this result must pair matching
        # weights and draws
        draws_per_component=draws_knd,
        importance_denominator=effective_denom,
        # advance the stored key: a chained default-key resample must get
        # fresh randomness (the reference's RNG state advances per call),
        # not replay fold_in(same key, 0x7E5A) and return identical draws
        key=jax.random.fold_in(key, 0x5EED),
    )


def _laplace_covariances(
    negH: jax.Array, fit_diag: jax.Array, method: str
):
    """Batched corrected covariances from the negative Hessians at the
    component means. Returns a batched :class:`WoodburyPDMat` (leading K
    axis) with an empty low-rank part (``m = 0``)."""
    K, d, _ = negH.shape
    dtype = negH.dtype
    B0 = jnp.zeros((d, 0), dtype)
    D0 = jnp.zeros((0, 0), dtype)
    if method == "diag":
        # Σ = diag(1 / diag(−H)); μ is generally NOT a stationary point,
        # so diag(−H) can have non-positive (or, for garbage means of
        # failed paths, non-finite) coordinates — those fall back
        # per-coordinate to the fitted covariance's diagonal (measured
        # mean ≲ 1 coordinate of 1000 on the bench target).
        hd = jax.vmap(jnp.diagonal)(negH)  # (K, d)
        usable = (hd > 0) & jnp.isfinite(hd)
        var = jnp.where(usable, 1.0 / jnp.maximum(hd, 1e-30), fit_diag)
        return jax.vmap(
            lambda v: WoodburyPDMat.from_parts(v, B0, D0)
        )(var)
    if method == "full":
        # Σ = (−H)⁻¹ with the saddle-free |λ| spectrum treatment (the
        # same decision as optimizer="newton", see design.md): negative
        # curvature directions keep their SCALE (variance 1/|λ|) — a
        # small positive floor would blow a clamped direction's variance
        # up to 1/floor (measured khat 4.4 at d=50 from ONE such
        # direction).
        w, V = jnp.linalg.eigh(negH)  # (K, d), (K, d, d)
        aw = jnp.abs(w)
        maxaw = jnp.max(aw, axis=1, keepdims=True)
        # a (near-)zero or non-finite Hessian (a failed path's garbage
        # mean, a likelihood plateau) has no usable curvature — that
        # component falls back WHOLE to the fitted diagonal, mirroring
        # the diag method's per-coordinate fallback
        degenerate = (maxaw <= 0) | ~jnp.isfinite(maxaw)  # (K, 1)
        floor = 1e-8 * jnp.where(degenerate, 1.0, maxaw)
        wc = jnp.maximum(aw, floor)
        sigma = jnp.einsum(
            "kde,ke,kfe->kdf", V, 1.0 / wc, V
        )  # V diag(1/wc) Vᵀ
        # eigh keeps Σ symmetric to rounding; symmetrize so the dense
        # Cholesky in from_parts sees an exactly-symmetric matrix
        sigma = 0.5 * (sigma + jnp.swapaxes(sigma, 1, 2))
        sigma = jnp.where(
            degenerate[:, :, None],
            jax.vmap(jnp.diag)(fit_diag),
            sigma,
        )
        return jax.vmap(
            lambda S: WoodburyPDMat.from_parts(S, B0, D0)
        )(sigma)
    raise ValueError(
        f"unknown laplace_resample method {method!r}; use 'diag' or 'full'"
    )


def laplace_corrected_components_and_draws(
    logp: Callable,
    components: MvNormal,
    key: jax.Array,
    ndraws_per_run: int,
    method: str = "diag",
    hess_fn: Optional[Callable] = None,
):
    """The jittable core of the Laplace correction, shared by
    :func:`laplace_resample`, ``bench.py``'s remedy column, and the
    multichip dryrun (one source of truth for the Hessian batching, the
    covariance construction, and the per-component draw keys).

    Returns ``(corrected components: MvNormal, draws_knd (K, N, d))``.
    """
    from pathfinder_tpu.models.protocol import cached_hessian

    if hess_fn is None:
        hess_fn = cached_hessian(logp)
    negH = -jax.vmap(hess_fn)(components.mean)  # (K, d, d)
    fit_diag = jax.vmap(lambda c: c.cov.diag())(components)  # (K, d)
    corrected = MvNormal(
        components.mean, _laplace_covariances(negH, fit_diag, method)
    )
    K = components.mean.shape[0]
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(K))
    draws_knd = jax.vmap(
        lambda c, k: c.sample(k, ndraws_per_run).T
    )(corrected, keys)
    return corrected, draws_knd


def laplace_resample(
    result: MultiPathfinderResult,
    ndraws: int,
    *,
    method: str = "diag",
    key: Optional[jax.Array] = None,
    ndraws_per_run: Optional[int] = None,
    replace: bool = True,
    importance: bool = True,
    importance_denominator: Optional[str] = None,
    hess: Optional[Callable] = None,
) -> MultiPathfinderResult:
    """Replace each component's covariance with a Laplace covariance at
    the same mean, redraw, re-weight, and resample (beyond reference).

    Pathfinder's component *covariances* are L-BFGS inverse-Hessian
    estimates accumulated along the trajectory; at the ELBO-selected
    means they can be far from the target's local curvature (the r03/r04
    oracle decomposition isolated the d=1000 bench target's residual
    Pareto-k̂ gap to exactly this mismatch). This correction keeps the
    algorithm's chosen means and swaps in the curvature the target
    actually has there:

    * ``method="diag"`` (default): ``Σ = diag(1 / diag(−H(μ)))`` with a
      per-coordinate fallback to the fitted diagonal where
      ``diag(−H) ≤ 0``. O(d) storage per component after the Hessian;
      measured khat 2.01→1.32 (lbfgs) / 1.60→1.06 (cg) and moment
      errors 2.3→1.1 sd at the d=1000 bench target.
    * ``method="full"``: ``Σ = (−H(μ))⁻¹`` via the saddle-free ``|λ|``
      eigendecomposition — captures cross-correlations; costs one dense
      ``eigh`` per component and stores (d, d) covariances. Measured
      khat 1.60→1.01 (cg) at d=1000.

    Both methods evaluate the target's Hessian at every component mean
    (``hess=`` callable if given, else the result target's order-2
    capability, else ``jax.hessian`` of the stored log density — d
    forward-over-reverse passes, batched over components). For
    transform-aware runs the Hessian is of the *linked* (unconstrained)
    density, matching the space the components live in.

    Returns a new result whose ``fit_distribution`` (and per-path
    ``states.fit_distribution`` views) hold the corrected components,
    with fresh per-component draws, a recomputed PSIS diagnostic, and
    ``ndraws`` resampled draws. ``elbo_values``/``elbo_se`` still
    describe the original (uncorrected) candidate fits. Chain with
    :func:`resample` for further re-resampling without re-correction.

    Not a universal win: when the fitted covariances already match the
    local curvature (small/moderate d, good verdicts — e.g. measured
    k̂ 0.65→1.02 at d=200 on the hierarchical target), the correction
    can be a slight negative. Like the optimizer choice, let the
    Pareto-k̂ arbitrate: apply it when the fitted verdict is bad and
    keep whichever result diagnoses better.
    """
    from pathfinder_tpu.models.protocol import cached_hessian
    from pathfinder_tpu.ops.optimizers import NEWTON_DENSE_DIM_WARN

    if method not in ("diag", "full"):
        raise ValueError(
            f"unknown laplace_resample method {method!r}; use 'diag' or "
            "'full'"
        )
    if key is None:
        key = jax.random.fold_in(result.key, 0x1A91)
    components = result.fit_distribution.components
    means = components.mean  # (K, d)
    K, d = means.shape
    if d > NEWTON_DENSE_DIM_WARN:
        warnings.warn(
            f"laplace_resample at d={d} materializes {K} dense "
            f"({d}, {d}) Hessians"
            + (" plus one eigh each" if method == "full" else "")
            + f" — expect high memory above d~{NEWTON_DENSE_DIM_WARN}."
        )
    if hess is None:
        hess = getattr(result.target, "hess", None)
    hess_fn = hess if hess is not None else cached_hessian(result.logp)

    N = (
        ndraws_per_run
        if ndraws_per_run is not None
        else result.draws_per_component.shape[1]
    )
    key_draw, key_res = jax.random.split(key)
    corrected, draws_knd = laplace_corrected_components_and_draws(
        result.logp, components, key_draw, N, method, hess_fn=hess_fn
    )
    mixture = UniformMixture(corrected)

    effective_denom = (
        importance_denominator
        or getattr(result, "importance_denominator", None)
        or "component"
    )
    psis_used = (
        _compute_psis_result(
            result.logp, corrected, draws_knd, denominator=effective_denom,
            chunk=getattr(result, "max_paths_per_launch", None),
        )
        if importance
        else None
    )
    draws, component_ids = resample_draws(
        key_res, draws_knd, psis_used, ndraws, replace=replace
    )

    from pathfinder_tpu.integrations.transforms import transformed_outputs

    draws_transformed, fit_transformed = transformed_outputs(
        result.transform, result.input, draws, mixture
    )
    return dataclasses.replace(
        result,
        fit_distribution=mixture,
        fit_distribution_transformed=fit_transformed,
        # keep the per-path result views self-consistent: path_result(k)
        # reads states.fit_distribution AND states.draws, so both the
        # corrected components and the draws they actually produced go in
        # (stale uncorrected draws paired with corrected fits would make
        # any per-path diagnostic silently wrong)
        states=result.states._replace(
            fit_distribution=corrected,
            draws=jnp.swapaxes(draws_knd, 1, 2),
        ),
        draws=draws,
        draw_component_ids=component_ids,
        draws_transformed=draws_transformed,
        psis_result=psis_used,
        draws_per_component=draws_knd,
        importance_denominator=effective_denom,
        key=jax.random.fold_in(key, 0x5EED),
    )
