"""Nonlinear conjugate gradient with trajectory trace — the second real
optimizer behind ``PathfinderConfig.optimizer``.

The reference accepts any Optimization.jl optimizer with callbacks and its
tests exercise BFGS/ConjugateGradient/NLopt (``src/singlepath.jl:120-123``,
``test/optimize.jl:104-135``); the fit stage then reconstructs L-BFGS
inverse-Hessians *from the trajectory*, whatever produced it
(``src/inverse_hessian.jl:25-66``). This module gives this package the
same property: :func:`minimize_cg_trace` emits the identical
:class:`~pathfinder_tpu.ops.lbfgs.OptimizationTrace` contract as
``minimize_lbfgs_trace``, so the Woodbury fits / ELBO / draw stages run
unchanged on a genuinely different optimization algorithm — pressure-testing
that they depend only on the trace.

Algorithm: Polak-Ribière+ (β = max(0, gₖ₊₁·(gₖ₊₁−gₖ)/gₖ·gₖ)) with automatic
steepest-descent restart on non-descent directions (Nocedal & Wright 2006,
Alg. 5.4 + eq. 5.45), sharing the line searches (Hager-Zhang default — the
line search of CG_DESCENT, Hager & Zhang 2005) and all stopping/abort
semantics with the L-BFGS driver.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from pathfinder_tpu.ops.lbfgs import (
    OptimizationTrace,
    scale_aware_gtol,
    should_abort_nonfinite,
)
from pathfinder_tpu.ops.linesearch import (
    initial_step_size,
    resolve_c1,
    resolve_line_search,
)

__all__ = ["minimize_cg_trace"]


class _CGState(NamedTuple):
    it: jax.Array
    x: jax.Array
    f: jax.Array  # minimization objective (-logp)
    g: jax.Array  # minimization gradient
    p: jax.Array  # previous search direction
    dphi0_prev: jax.Array  # gᵀp at the previous accepted step
    step_prev: jax.Array  # previous accepted step size
    nev: jax.Array
    nexh: jax.Array
    done: jax.Array
    xs: jax.Array
    fs: jax.Array
    gs: jax.Array


def minimize_cg_trace(
    value_and_grad: Callable,
    x0: jax.Array,
    maxiters: int = 1000,
    history_length: int = 6,  # unused; uniform driver signature
    gtol: float = 1e-8,
    ftol: float = 10.0,
    epsilon_curvature: float = 1e-12,  # unused; uniform driver signature
    max_ls_evals: int = 12,
    c1: Optional[float] = None,
    c2: float = 0.9,
    fail_on_nonfinite: bool = True,
    progress_every: int = 0,
    line_search: str = "hager_zhang",
) -> OptimizationTrace:
    """Maximize ``logp`` with PR+ nonlinear CG, recording the trajectory.

    Same contract, conventions, and stopping/abort semantics as
    :func:`~pathfinder_tpu.ops.lbfgs.minimize_lbfgs_trace` (trace in the
    logp view; record-then-abort non-finite handling; gtol clamp; ftol
    relative-progress stop in ulp units). ``num_bfgs_updates_rejected`` in
    the returned trace is 0 — CG keeps no curvature pairs; the fit stage
    re-derives its own (guarded) L-BFGS history from the trace.
    """
    d = x0.shape[0]
    dtype = x0.dtype
    gtol_user = float(gtol)
    ftol_rel = float(ftol) * float(jnp.finfo(dtype).eps) if ftol > 0 else 0.0
    ls_fn = resolve_line_search(line_search)
    c1 = resolve_c1(c1, line_search)

    def neg_vg(x):
        lp, glp = value_and_grad(x)
        return (-lp).astype(dtype), (-glp).astype(dtype)

    f0, g0 = neg_vg(x0)
    gtol = scale_aware_gtol(gtol_user, g0, dtype)
    init_abort = should_abort_nonfinite(-f0, -g0, fail_on_nonfinite)

    xs = jnp.zeros((maxiters + 1, d), dtype).at[0].set(x0)
    fs = jnp.zeros((maxiters + 1,), dtype).at[0].set(-f0)
    gs = jnp.zeros((maxiters + 1, d), dtype).at[0].set(-g0)

    state = _CGState(
        it=jnp.asarray(0),
        x=x0,
        f=f0,
        g=g0,
        p=jnp.zeros((d,), dtype),
        dphi0_prev=jnp.zeros((), dtype),
        step_prev=jnp.ones((), dtype),
        nev=jnp.asarray(1),
        nexh=jnp.asarray(0),
        done=init_abort,
        xs=xs,
        fs=fs,
        gs=gs,
    )

    def cond(s: _CGState):
        return (~s.done) & (s.it < maxiters)

    def body(s: _CGState):
        # PR+ β against the gradient at the *previous* iterate (trace row
        # it−1, minimizer view); at it==0 the β term is unused
        g_prev = -s.gs[jnp.maximum(s.it - 1, 0)]
        gg_prev = jnp.vdot(g_prev, g_prev)
        beta = jnp.vdot(s.g, s.g - g_prev) / jnp.where(
            gg_prev > 0, gg_prev, 1.0
        )
        beta = jnp.maximum(beta, 0.0)
        direction = jnp.where(s.it == 0, -s.g, -s.g + beta * s.p)
        dphi0 = jnp.vdot(s.g, direction)
        # restart with steepest descent when not a descent direction
        bad_dir = ~(dphi0 < 0)
        direction = jnp.where(bad_dir, -s.g, direction)
        dphi0 = jnp.where(bad_dir, -jnp.vdot(s.g, s.g), dphi0)

        # initial trial step: first iteration uses the shared heuristic;
        # later ones carry slope information across iterations
        # (α₀ = α_{k-1}·dφ₀_{k-1}/dφ₀, N&W eq. 3.60), clipped for safety
        a0_first = initial_step_size(s.x, s.f, s.g)
        a0_carry = s.step_prev * s.dphi0_prev / jnp.where(
            dphi0 < 0, dphi0, -1.0
        )
        a0_carry = jnp.clip(a0_carry, 1e-8, 1e4)
        a0_carry = jnp.where(jnp.isfinite(a0_carry), a0_carry, 1.0)
        alpha0 = jnp.where(s.it == 0, a0_first, a0_carry.astype(dtype))

        ls = ls_fn(
            neg_vg, s.x, s.f, s.g, direction, alpha0,
            c1=c1, c2=c2, max_evals=max_ls_evals,
        )
        # no per-lane done gating needed: JAX's batched while_loop
        # select-masks the whole carry for finished lanes (see the same
        # note in minimize_lbfgs_trace)
        nev = s.nev + ls.num_evals

        x_new = s.x + ls.step_size * direction
        f_new, g_new = ls.f, ls.g
        progress = ls.ok
        abort = should_abort_nonfinite(-f_new, -g_new, fail_on_nonfinite)
        nexh = s.nexh + jnp.where(progress & ls.exhausted, 1, 0)

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
                print(f"  CG iter {int(it)}/{maxiters} logp={float(fx):.4g}")

            jax.lax.cond(
                (it_new % progress_every) == 0,
                lambda args: jax.debug.callback(_report, *args),
                lambda args: None,
                (it_new, -f_new),
            )

        return _CGState(
            it=it_new,
            x=jnp.where(progress, x_new, s.x),
            f=jnp.where(progress, f_new, s.f),
            g=jnp.where(progress, g_new, s.g),
            p=jnp.where(progress, direction, s.p),
            dphi0_prev=jnp.where(progress, dphi0, s.dphi0_prev),
            step_prev=jnp.where(progress, ls.step_size, s.step_prev),
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
        num_bfgs_updates_rejected=jnp.asarray(0),
        num_fn_evals=final.nev,
        num_ls_exhausted=final.nexh,
    )
