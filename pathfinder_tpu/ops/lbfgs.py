"""L-BFGS with trajectory trace + inverse-Hessian reconstruction.

Replaces three reference components with fixed-shape JAX equivalents:

* the external ``Optim.LBFGS`` + callback trace driver
  (``src/optimize.jl:35-121``) becomes :func:`minimize_lbfgs_trace`, a
  ``lax.while_loop`` writing into preallocated ``(maxiters+1, d)`` trace
  buffers with a valid-length scalar (the variable-length ``Vector`` trace of
  the reference, as masks);
* the history-window inverse-Hessian reconstruction
  (``lbfgs_inverse_hessians`` / ``lbfgs_inverse_hessian``,
  ``src/inverse_hessian.jl:25-133``) becomes :func:`lbfgs_inverse_hessians`,
  which rebuilds every per-iteration Woodbury factor from the trace with
  gathers instead of a circular buffer — all shapes static, all candidates
  built by one batched ``vmap``;
* ``gilbert_init`` (``src/inverse_hessian.jl:5-10``) is ported as the
  diagonal-H₀ refresh.

Conventions: the *trace* stores the log-density view (``logp`` values and
``∇logp`` gradients), exactly like the reference's ``OptimizationTrace``
(sign-flipped from the minimizer's view, ``src/optimize.jl:94-96``); the
optimizer internally minimizes ``f = -logp``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from pathfinder_tpu.ops.linesearch import (
    initial_step_size,
    resolve_c1,
    resolve_line_search,
)
from pathfinder_tpu.ops.woodbury import WoodburyPDMat, matmul

__all__ = [
    "gilbert_init",
    "should_abort_nonfinite",
    "minimize_lbfgs_trace",
    "OptimizationTrace",
    "lbfgs_inverse_hessian",
    "lbfgs_inverse_hessians",
    "lbfgs_history_aux",
    "lbfgs_fits_at",
    "LbfgsHistoryAux",
    "history_windows",
]


def should_abort_nonfinite(logp_value, grad_logp, fail_on_nonfinite=True):
    """The reference callback's abort predicate, in the logp view
    (``src/optimize.jl:103-105``): abort iff ``fail_on_nonfinite`` and
    (``isnan(logp)`` or ``logp == +Inf`` or any gradient entry non-finite).
    Note ``logp == -Inf`` (zero density) does NOT abort — the optimizer is
    allowed to descend out of a zero-density region."""
    bad = (
        jnp.isnan(logp_value)
        | (logp_value == jnp.inf)
        | jnp.any(~jnp.isfinite(grad_logp))
    )
    return jnp.asarray(fail_on_nonfinite) & bad


def gilbert_init(alpha, s, y):
    """Diagonal H₀ refresh, Gilbert & Lemaréchal (1989) eq. 4.9
    (parity: ``gilbert_init``, ``src/inverse_hessian.jl:5-10``)."""
    a = jnp.sum(y * alpha * y)
    b = jnp.sum(y * s)
    c = jnp.sum(s / alpha * s)
    return b / (a / alpha + y * y - (a / c) * (s / alpha) ** 2)


class OptimizationTrace(NamedTuple):
    """Fixed-shape optimization trace (parity: ``OptimizationTrace``,
    ``src/optimize.jl:110-121``). Index 0 is the initial point. Entries with
    index ≥ ``num_valid`` are padding."""

    xs: jax.Array  # (maxiters+1, d) iterates
    log_densities: jax.Array  # (maxiters+1,) logp values
    gradients: jax.Array  # (maxiters+1, d) ∇logp
    num_valid: jax.Array  # () int: number of valid points (≥ 1)
    num_bfgs_updates_rejected: jax.Array  # () int
    num_fn_evals: jax.Array  # () int: value_and_grad evaluations
    # () int: steps kept via the line search's exhausted-budget fallback
    # rather than a point satisfying the (approximate) Wolfe conditions —
    # a trajectory-quality diagnostic (many exhaustions = raise max_ls_evals)
    num_ls_exhausted: jax.Array = 0

    @property
    def point_mask(self) -> jax.Array:
        n = self.xs.shape[0]
        return jnp.arange(n) < self.num_valid


class _LoopState(NamedTuple):
    it: jax.Array
    x: jax.Array
    f: jax.Array  # minimization objective (-logp)
    g: jax.Array  # minimization gradient
    alpha: jax.Array  # (d,) diag H0
    S: jax.Array  # (J, d) step history rows
    Y: jax.Array  # (J, d) grad-diff history rows
    pos: jax.Array  # index of most recent history row
    hlen: jax.Array  # effective history length
    nrej: jax.Array
    nev: jax.Array
    nexh: jax.Array  # line-search exhaustion count
    done: jax.Array
    xs: jax.Array
    fs: jax.Array
    gs: jax.Array


def _compact_pieces(S_masked, Y_masked, alpha, mask):
    """Masked compact-representation pieces shared by the two-loop
    direction and the inverse-Hessian reconstruction: ``R = triu(S Yᵀ)``
    over active rows (identity on inactive so it stays invertible),
    ``E = diag(R)`` on active rows, and ``YaY = Y diag(α) Yᵀ``. Keeping
    ONE copy guarantees the optimizer's search direction and the
    reconstructed fits use identical masking semantics."""
    J = S_masked.shape[0]
    dtype = alpha.dtype
    eyeJ = jnp.eye(J, dtype=dtype)
    mm = mask[:, None] * mask[None, :]
    R = jnp.triu(matmul(S_masked, Y_masked.T)) * mm + eyeJ * (1.0 - mask)
    E = jnp.diagonal(R) * mask
    YaY = matmul(Y_masked, (alpha[None, :] * Y_masked).T)
    return R, E, YaY, eyeJ


def _two_loop_direction(g, alpha, S, Y, pos, hlen):
    """``−H·g`` over the masked circular history via the compact
    representation (Byrd et al. 1994, Thm 2.2) — mathematically identical to
    the classic two-loop recursion, but expressed as one J×J matmul plus two
    J×J triangular solves instead of 2J sequential gather+dot pairs.

    The sequential two-loop is 2J dependent gather+dot steps; the compact
    form is a few batched matmuls and solves, at O(J²·d) instead of O(J·d)
    flops.
    """
    from jax.scipy.linalg import solve_triangular

    J = S.shape[0]
    if J == 0:
        return -(alpha * g)
    dtype = g.dtype

    # chronological (oldest→newest) view of the circular buffer; when the
    # history is short, the first J−hlen rows are masked out
    order = (pos - (J - 1) + jnp.arange(J)) % J
    mask = (jnp.arange(J) >= (J - hlen)).astype(dtype)
    S_ord = S[order] * mask[:, None]
    Y_ord = Y[order] * mask[:, None]

    R, E, YaY, _ = _compact_pieces(S_ord, Y_ord, alpha, mask)

    u1 = matmul(Y_ord, alpha * g)  # B₁ᵀ g
    u2 = matmul(S_ord, g)  # B₂ᵀ g
    w = solve_triangular(R, u2, lower=False)  # R⁻¹ u2
    d1 = -w
    inner = -u1 + E * w + matmul(YaY, w)
    d2 = solve_triangular(R, inner, lower=False, trans=1)  # R⁻ᵀ(...)

    Hg = alpha * g + alpha * matmul(Y_ord.T, d1) + matmul(S_ord.T, d2)
    return -Hg


def scale_aware_gtol(gtol_user, g0, dtype):
    """Effective gradient tolerance: the user's ``gtol`` floored at the
    dtype's resolution AT THE PROBLEM'S GRADIENT SCALE. A pure-absolute
    25·eps floor would declare small-scaled targets (max|∇logp| < 3e-6 in
    f32) converged after one step — eps is relative precision, not an
    absolute gradient resolution — so ``min(1, |g0|∞)`` lowers the floor
    for such targets while O(1)+ problems keep the measured floor. The
    floor is deliberately NOT raised for large-scale problems (that would
    override an explicit user gtol); there the ``ftol`` relative-progress
    stall already terminates noise-floor trajectories. Shared by all
    four trajectory drivers (lbfgs/cg/bfgs/newton) so their stopping
    semantics stay identical."""
    floor = 25 * jnp.finfo(dtype).eps
    g0_scale = jnp.max(jnp.abs(g0))
    g0_scale = jnp.where(
        jnp.isfinite(g0_scale) & (g0_scale > 0), g0_scale, 1.0
    )
    return jnp.maximum(
        jnp.asarray(gtol_user, dtype), floor * jnp.minimum(1.0, g0_scale)
    )


def minimize_lbfgs_trace(
    value_and_grad: Callable,
    x0: jax.Array,
    maxiters: int = 1000,
    history_length: int = 6,
    gtol: float = 1e-8,
    ftol: float = 10.0,
    epsilon_curvature: float = 1e-12,
    max_ls_evals: int = 12,
    c1: Optional[float] = None,
    c2: float = 0.9,
    fail_on_nonfinite: bool = True,
    progress_every: int = 0,
    line_search: str = "hager_zhang",
) -> OptimizationTrace:
    """Maximize ``logp`` with L-BFGS, recording the full trajectory.

    ``progress_every > 0`` emits a host callback every that many iterations
    (the per-iteration progress events of ``src/optimize.jl:91-92``; off by
    default since host callbacks serialize the device stream).

    ``value_and_grad(x) -> (logp, ∇logp)``. Parity target:
    ``optimize_with_trace`` + default optimizer config
    (``src/optimize.jl:35-59``, ``src/Pathfinder.jl:29-35``): history length
    ``J``, Wolfe line search, gradient-norm stopping, non-finite handling
    (``src/optimize.jl:103-105``).

    ``fail_on_nonfinite`` follows the reference callback's semantics
    (:func:`should_abort_nonfinite`): with ``True`` (default) the loop stops
    as soon as an *evaluated-and-kept* iterate — the initial point or an
    accepted line-search step — has ``isnan(logp)``, ``logp == +Inf``, or a
    non-finite gradient entry (``logp == -Inf`` is tolerated, exactly like
    the reference: the optimizer may climb out of a zero-density region).
    With ``False`` optimization continues past such a point, relying on the
    curvature guard / NaN-skipping ELBO argmax downstream — mirroring the
    reference, where the solve flounders on from the non-finite iterate. One
    divergence either way: non-finite *trial* values inside the line search
    make it backtrack and are never recorded, so the trace only ever holds
    points the search kept (observationally equivalent to the reference's
    record-then-abort via the NaN-skip argmax, ``src/utils.jl:51-72``).
    """
    d = x0.shape[0]
    dtype = x0.dtype
    J = history_length
    gtol_user = float(gtol)
    # relative objective-progress stop: terminate when a step improves f by
    # less than ftol ulps (ftol * eps * |f|). In f32 the gradient-norm test
    # alone is often unreachable at d >> 1 while the Hager-Zhang approximate
    # Wolfe conditions keep accepting noise-floor steps — without this stop
    # such trajectories run to maxiters doing no useful work (measured 41%
    # of d=1000 bench paths). ftol is in ulp units; <= 0 disables.
    ftol_rel = float(ftol) * float(jnp.finfo(dtype).eps) if ftol > 0 else 0.0
    ls_fn = resolve_line_search(line_search)
    c1 = resolve_c1(c1, line_search)

    def neg_vg(x):
        lp, glp = value_and_grad(x)
        # cast to the state dtype (user targets may compute in higher precision)
        return (-lp).astype(dtype), (-glp).astype(dtype)

    f0, g0 = neg_vg(x0)
    gtol = scale_aware_gtol(gtol_user, g0, dtype)
    # abort rule in the minimizer view: f = -logp, so logp==+Inf ⇔ f==-Inf
    init_abort = should_abort_nonfinite(-f0, -g0, fail_on_nonfinite)
    # a NaN/Inf-gradient start can't make progress either way; with
    # fail_on_nonfinite=False we still *attempt* a step (reference: the solve
    # continues and flounders), which burns line-search evals but ends with
    # the same 1-point trace

    xs = jnp.zeros((maxiters + 1, d), dtype).at[0].set(x0)
    fs = jnp.zeros((maxiters + 1,), dtype).at[0].set(-f0)
    gs = jnp.zeros((maxiters + 1, d), dtype).at[0].set(-g0)

    state = _LoopState(
        it=jnp.asarray(0),
        x=x0,
        f=f0,
        g=g0,
        alpha=jnp.ones((d,), dtype),
        S=jnp.zeros((J, d), dtype),
        Y=jnp.zeros((J, d), dtype),
        pos=jnp.asarray(0),
        hlen=jnp.asarray(0),
        nrej=jnp.asarray(0),
        nev=jnp.asarray(1),
        nexh=jnp.asarray(0),
        done=init_abort,
        xs=xs,
        fs=fs,
        gs=gs,
    )

    def cond(s: _LoopState):
        return (~s.done) & (s.it < maxiters)

    def body(s: _LoopState):
        direction = _two_loop_direction(s.g, s.alpha, s.S, s.Y, s.pos, s.hlen)
        dphi0 = jnp.vdot(s.g, direction)
        # safeguard: fall back to scaled steepest descent if not a descent dir
        bad_dir = ~(dphi0 < 0)
        direction = jnp.where(bad_dir, -s.alpha * s.g, direction)

        a0_first = initial_step_size(s.x, s.f, s.g)
        alpha0 = jnp.where(s.it == 0, a0_first, jnp.ones((), dtype))

        ls = ls_fn(
            neg_vg, s.x, s.f, s.g, direction, alpha0,
            c1=c1, c2=c2, max_evals=max_ls_evals,
        )
        # no per-lane done gating is needed under vmap/shard_map: JAX's
        # while_loop batching rule select-masks the *entire carry* for lanes
        # whose own cond is False, so a finished lane's state (including
        # nev) is frozen even while its device group keeps iterating —
        # verified empirically: traces and eval counts are bit-identical
        # between unsharded and sharded runs for both optimizers
        nev = s.nev + ls.num_evals

        x_new = s.x + ls.step_size * direction
        f_new, g_new = ls.f, ls.g
        # the line searches only accept finite objective values, so an
        # accepted step is recorded unconditionally (the reference callback
        # records every iterate, src/optimize.jl:99-101); the abort decision
        # is separate (record-then-abort, :103-105)
        progress = ls.ok
        abort = should_abort_nonfinite(-f_new, -g_new, fail_on_nonfinite)
        nexh = s.nexh + jnp.where(progress & ls.exhausted, 1, 0)

        # curvature-guarded history update (src/inverse_hessian.jl:46-58)
        svec = x_new - s.x
        yvec = g_new - s.g  # minimizer-view y = ∇f_{l+1} − ∇f_l
        curv = jnp.vdot(yvec, svec)
        accept = progress & (curv > epsilon_curvature * jnp.sum(yvec * yvec))

        write = (s.pos + 1) % J if J > 0 else s.pos
        S = s.S.at[write].set(jnp.where(accept, svec, s.S[write])) if J > 0 else s.S
        Y = s.Y.at[write].set(jnp.where(accept, yvec, s.Y[write])) if J > 0 else s.Y
        pos = jnp.where(accept, write, s.pos)
        hlen = jnp.where(accept, jnp.minimum(s.hlen + 1, J), s.hlen)
        alpha = jnp.where(accept, gilbert_init(s.alpha, svec, yvec), s.alpha)
        nrej = s.nrej + jnp.where(progress & ~accept, 1, 0)

        it_new = jnp.where(progress, s.it + 1, s.it)
        xs = s.xs.at[it_new].set(jnp.where(progress, x_new, s.xs[it_new]))
        fs = s.fs.at[it_new].set(jnp.where(progress, -f_new, s.fs[it_new]))
        gs = s.gs.at[it_new].set(jnp.where(progress, -g_new, s.gs[it_new]))

        converged = jnp.max(jnp.abs(g_new)) <= gtol
        if ftol_rel > 0:
            stalled = progress & (
                (s.f - f_new) <= ftol_rel * (jnp.abs(f_new) + ftol_rel)
            )
        else:
            stalled = jnp.asarray(False)
        done = (~progress) | converged | stalled | (progress & abort)

        if progress_every > 0:
            def _report(it, fx):
                print(f"  L-BFGS iter {int(it)}/{maxiters} logp={float(fx):.4g}")

            jax.lax.cond(
                (it_new % progress_every) == 0,
                lambda args: jax.debug.callback(_report, *args),
                lambda args: None,
                (it_new, -f_new),
            )

        return _LoopState(
            it=it_new,
            x=jnp.where(progress, x_new, s.x),
            f=jnp.where(progress, f_new, s.f),
            g=jnp.where(progress, g_new, s.g),
            alpha=alpha,
            S=S,
            Y=Y,
            pos=pos,
            hlen=hlen,
            nrej=nrej,
            nev=nev,
            nexh=nexh,
            done=done,
            xs=xs,
            fs=fs,
            gs=gs,
        )

    final = lax.while_loop(cond, body, state)
    return OptimizationTrace(
        xs=final.xs,
        log_densities=final.fs,
        gradients=final.gs,
        num_valid=final.it + 1,
        num_bfgs_updates_rejected=final.nrej,
        num_fn_evals=final.nev,
        num_ls_exhausted=final.nexh,
    )


def lbfgs_inverse_hessian(alpha, S, Y, row_mask) -> WoodburyPDMat:
    """Inverse-Hessian estimate from one history window (parity:
    ``lbfgs_inverse_hessian``, ``src/inverse_hessian.jl:98-133``; Byrd et al.
    1994 Theorem 2.2).

    ``S``/``Y`` are ``(J, d)`` with rows in *chronological* order (oldest
    first); ``row_mask`` (J,) marks the rows actually present. Returns
    ``W = diag(α) + B D Bᵀ`` with ``B = [αY | S]`` (d × 2J) and

        R = triu(S Yᵀ),  E = I∘R,
        D = [[0, −R⁻¹], [−R⁻ᵀ, R⁻ᵀ(E + Y diag(α) Yᵀ) R⁻¹]].

    Masked rows contribute nothing: R gets a unit diagonal there (keeping the
    triangular solve well-posed) and the final D rows/columns are zeroed, so
    together with the Woodbury column mask the masked dimensions vanish
    identically — the fixed-shape replacement for the reference's
    variable-size windows.
    """
    J, dvec = S.shape
    dtype = alpha.dtype
    if J == 0:
        B = jnp.zeros((dvec, 0), dtype)
        D = jnp.zeros((0, 0), dtype)
        return WoodburyPDMat.from_parts(alpha, B, D)

    mask = row_mask.astype(dtype)
    S = S * mask[:, None]
    Y = Y * mask[:, None]

    B = jnp.concatenate([(alpha[None, :] * Y).T, S.T], axis=1)  # (d, 2J)

    R, E, YaY, eyeJ = _compact_pieces(S, Y, alpha, mask)

    from jax.scipy.linalg import solve_triangular

    nRinv = solve_triangular(R, -eyeJ, lower=False)  # −R⁻¹
    inner = jnp.diag(E) + YaY
    D22 = matmul(matmul(nRinv.T, inner), nRinv)  # R⁻ᵀ(E + YαYᵀ)R⁻¹
    Dtop = jnp.concatenate([jnp.zeros((J, J), dtype), nRinv], axis=1)
    Dbot = jnp.concatenate([nRinv.T, D22], axis=1)
    D = jnp.concatenate([Dtop, Dbot], axis=0)
    mask2 = jnp.concatenate([mask, mask])
    return WoodburyPDMat.from_parts(alpha, B, D, col_mask=mask2)


def history_windows(accept, history_length):
    """Index machinery mapping each trajectory point to its history window.

    Given ``accept`` (L,) flags for steps ``1..L``, returns for each point
    ``l ∈ 0..L`` the step indices (into the ``(L, d)`` step arrays) of the at
    most ``J`` most recent accepted steps ≤ l in chronological order, plus a
    validity mask — the gather-based replacement for the reference's circular
    buffer + ``mod1`` reordering (``src/inverse_hessian.jl:49-52,105``).
    Returns ``(idx (L+1, J), mask (L+1, J))``.
    """
    L = accept.shape[0]
    acc_list, c_points = _accept_index(accept)
    return _windows_at(
        acc_list, c_points, jnp.arange(L + 1), history_length, L
    )


def _accept_index(accept):
    """(acc_list, c_points): the r-th accepted step's index, and the number
    of accepted steps strictly before each trajectory point."""
    L = accept.shape[0]
    c = jnp.cumsum(accept.astype(jnp.int32))  # accepted among steps 0..i
    c_points = jnp.concatenate([jnp.zeros((1,), c.dtype), c])  # (L+1,)
    slots = jnp.where(accept, c - 1, L)  # scatter target (L = dropped)
    acc_list = jnp.zeros((L + 1,), jnp.int32).at[slots].set(
        jnp.arange(L, dtype=jnp.int32), mode="drop"
    )
    return acc_list, c_points


def _windows_at(acc_list, c_points, points, history_length, L):
    """History-window step indices + mask for the given trajectory points."""
    J = history_length
    ranks = c_points[points][:, None] - J + jnp.arange(J, dtype=jnp.int32)[None, :]
    mask = ranks >= 0
    idx = acc_list[jnp.clip(ranks, 0, L)]
    return jnp.where(mask, idx, 0), mask


class LbfgsHistoryAux(NamedTuple):
    """Precomputed per-trajectory quantities from which the inverse-Hessian
    at ANY point can be rebuilt by a gather — O(L·d) once, then O(J·d) per
    point. The decomposition that makes chunked/lazy fit construction
    possible (memory stays bounded for maxiters ≫ trajectory length)."""

    s_steps: jax.Array  # (L, d)
    y_steps: jax.Array  # (L, d) minimizer-view y
    accept: jax.Array  # (L,) curvature-accepted flags
    alphas: jax.Array  # (L+1, d) diag H₀ per point
    acc_list: jax.Array  # (L+1,) step index of r-th accepted step
    c_points: jax.Array  # (L+1,) #accepted among steps < point
    point_mask: jax.Array  # (L+1,)
    num_rejected: jax.Array  # ()


def lbfgs_history_aux(
    trace: OptimizationTrace,
    epsilon_curvature: float = 1e-12,
) -> LbfgsHistoryAux:
    """Step differences, curvature acceptance, and the diag-H₀ recursion
    (reference ``lbfgs_inverse_hessians`` preamble,
    ``src/inverse_hessian.jl:25-66``)."""
    xs, grads = trace.xs, trace.gradients
    L = xs.shape[0] - 1
    dtype = xs.dtype

    s_steps = xs[1:] - xs[:-1]  # (L, d)
    y_steps = grads[:-1] - grads[1:]  # ∇logp_l − ∇logp_{l+1} (minimizer y)
    point_mask = trace.point_mask  # (L+1,)
    step_valid = point_mask[1:]
    curv = jnp.sum(y_steps * s_steps, axis=1)
    accept = step_valid & (curv > epsilon_curvature * jnp.sum(y_steps**2, axis=1))
    num_rejected = jnp.sum(step_valid & ~accept)

    def alpha_step(alpha, inp):
        s, y, acc = inp
        new = gilbert_init(alpha, s, y)
        alpha = jnp.where(acc, new, alpha)
        return alpha, alpha

    alpha0 = jnp.ones((xs.shape[1],), dtype)
    _, alphas_tail = lax.scan(alpha_step, alpha0, (s_steps, y_steps, accept))
    alphas = jnp.concatenate([alpha0[None], alphas_tail], axis=0)  # (L+1, d)

    acc_list, c_points = _accept_index(accept)
    return LbfgsHistoryAux(
        s_steps=s_steps,
        y_steps=y_steps,
        accept=accept,
        alphas=alphas,
        acc_list=acc_list,
        c_points=c_points,
        point_mask=point_mask,
        num_rejected=num_rejected,
    )


def lbfgs_fits_at(aux: LbfgsHistoryAux, points: jax.Array, history_length: int):
    """Inverse-Hessian Woodbury factors at the given trajectory ``points``
    (any subset, any order) — batched build via one ``vmap``."""
    L = aux.s_steps.shape[0]
    idx, mask = _windows_at(aux.acc_list, aux.c_points, points, history_length, L)
    S_w = aux.s_steps[idx]  # (C, J, d)
    Y_w = aux.y_steps[idx]
    return jax.vmap(lbfgs_inverse_hessian)(aux.alphas[points], S_w, Y_w, mask)


def lbfgs_inverse_hessians(
    trace: OptimizationTrace,
    history_length: int = 6,
    epsilon_curvature: float = 1e-12,
):
    """Rebuild the per-point inverse-Hessian sequence from a trajectory
    (parity: ``lbfgs_inverse_hessians``, ``src/inverse_hessian.jl:25-66``).

    Returns a *batched* :class:`WoodburyPDMat` (leading axis = trajectory
    point 0..L), the per-point validity mask, and the number of rejected
    updates. All L+1 factorizations are built by one ``vmap``, so the m×m
    cores are batched instead of running sequentially.
    """
    aux = lbfgs_history_aux(trace, epsilon_curvature)
    L = trace.xs.shape[0] - 1
    fits = lbfgs_fits_at(aux, jnp.arange(L + 1), history_length)
    return fits, aux.point_mask, aux.num_rejected
