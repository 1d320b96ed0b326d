"""Dense-BFGS with trajectory trace — the third real optimizer behind
``PathfinderConfig.optimizer``.

The reference's pluggable-optimizer axis is tested with Optim.BFGS,
Optim.LBFGS, Optim.ConjugateGradient, and NLopt LD_LBFGS
(``test/optimize.jl:104-137``); this module adds the dense-BFGS member of
that set. Like :mod:`pathfinder_tpu.ops.cg`, it emits the identical
:class:`~pathfinder_tpu.ops.lbfgs.OptimizationTrace` contract so the
Woodbury-fit / ELBO / draw stages run unchanged — the fit stage always
re-derives its own (guarded) L-BFGS history from the trace, whatever
produced it (``src/inverse_hessian.jl:25-66``).

Algorithm: inverse-Hessian BFGS (Nocedal & Wright 2006, Alg. 6.1 / eq.
6.17), H₀ rescaled to ``(sᵀy / yᵀy)·I`` at the first accepted update (N&W
eq. 6.20), curvature-guarded updates (``sᵀy > ε‖y‖²`` — the same guard and
counter as the L-BFGS driver), steepest-descent restart with an identity
reset when rounding costs H positive-definiteness. The ``H·g`` direction
and the rank-2 update are dense (d×d) matmuls — O(d²) memory and
per-iteration FLOPs, so prefer ``lbfgs`` at large ``d``; this optimizer
exists for trajectory diversity (its steps differ genuinely from L-BFGS's
limited-memory ones) and reference parity.

Shares the line searches and every stopping/abort semantic with the
L-BFGS and CG drivers.
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

__all__ = ["minimize_bfgs_trace"]


class _BFGSState(NamedTuple):
    it: jax.Array
    x: jax.Array
    f: jax.Array  # minimization objective (-logp)
    g: jax.Array  # minimization gradient
    H: jax.Array  # (d, d) inverse-Hessian estimate
    n_updates: jax.Array  # accepted BFGS updates (for the H0 rescale)
    nev: jax.Array
    nrej: jax.Array
    nexh: jax.Array
    done: jax.Array
    xs: jax.Array
    fs: jax.Array
    gs: jax.Array


def minimize_bfgs_trace(
    value_and_grad: Callable,
    x0: jax.Array,
    maxiters: int = 1000,
    history_length: int = 6,  # unused; uniform driver signature
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
    """Maximize ``logp`` with dense inverse-Hessian BFGS, recording the
    trajectory.

    Same contract, conventions, and stopping/abort semantics as
    :func:`~pathfinder_tpu.ops.lbfgs.minimize_lbfgs_trace` (trace in the
    logp view; record-then-abort non-finite handling; shared gtol clamp;
    ftol relative-progress stop in ulp units).
    ``num_bfgs_updates_rejected`` counts curvature-rejected H updates —
    the same event the L-BFGS driver counts.
    """
    d = x0.shape[0]
    dtype = x0.dtype
    gtol_user = float(gtol)
    eps_curv = float(epsilon_curvature)
    ftol_rel = float(ftol) * float(jnp.finfo(dtype).eps) if ftol > 0 else 0.0
    ls_fn = resolve_line_search(line_search)
    c1 = resolve_c1(c1, line_search)

    def neg_vg(x):
        lp, glp = value_and_grad(x)
        return (-lp).astype(dtype), (-glp).astype(dtype)

    f0, g0 = neg_vg(x0)
    gtol = scale_aware_gtol(gtol_user, g0, dtype)
    init_abort = should_abort_nonfinite(-f0, -g0, fail_on_nonfinite)

    eye = jnp.eye(d, dtype=dtype)
    xs = jnp.zeros((maxiters + 1, d), dtype).at[0].set(x0)
    fs = jnp.zeros((maxiters + 1,), dtype).at[0].set(-f0)
    gs = jnp.zeros((maxiters + 1, d), dtype).at[0].set(-g0)

    state = _BFGSState(
        it=jnp.asarray(0),
        x=x0,
        f=f0,
        g=g0,
        H=eye,
        n_updates=jnp.asarray(0),
        nev=jnp.asarray(1),
        nrej=jnp.asarray(0),
        nexh=jnp.asarray(0),
        done=init_abort,
        xs=xs,
        fs=fs,
        gs=gs,
    )

    def cond(s: _BFGSState):
        return (~s.done) & (s.it < maxiters)

    def body(s: _BFGSState):
        direction = -(s.H @ s.g)
        dphi0 = jnp.vdot(s.g, direction)
        # rounding can cost H positive-definiteness: restart with steepest
        # descent from a fresh identity estimate, and reset the update
        # counter so the next accepted pair re-applies the eq. 6.20 scale
        # (an unscaled identity after a restart would make the natural
        # unit step orders of magnitude off on badly scaled targets)
        bad_dir = ~(dphi0 < 0)
        direction = jnp.where(bad_dir, -s.g, direction)
        dphi0 = jnp.where(bad_dir, -jnp.vdot(s.g, s.g), dphi0)
        H = jnp.where(bad_dir, eye, s.H)
        n_upd = jnp.where(bad_dir, 0, s.n_updates)

        # first iteration: shared step heuristic; afterwards the BFGS
        # natural step alpha0 = 1 (the scaling that makes the unit step
        # acceptable near the optimum is exactly what H carries)
        alpha0 = jnp.where(
            s.it == 0,
            initial_step_size(s.x, s.f, s.g),
            jnp.ones((), dtype),
        )

        ls = ls_fn(
            neg_vg, s.x, s.f, s.g, direction, alpha0,
            c1=c1, c2=c2, max_evals=max_ls_evals,
        )
        nev = s.nev + ls.num_evals

        x_new = s.x + ls.step_size * direction
        f_new, g_new = ls.f, ls.g
        progress = ls.ok
        abort = should_abort_nonfinite(-f_new, -g_new, fail_on_nonfinite)
        nexh = s.nexh + jnp.where(progress & ls.exhausted, 1, 0)

        # curvature-guarded BFGS update (N&W eq. 6.17); the guard is the
        # LITERAL `s·y > eps*|y|^2` rule of the L-BFGS history
        # (src/inverse_hessian.jl:47; ops/lbfgs.py applies the same), so
        # the driver's rejection count agrees with the fit stage's
        # re-derived aux.num_rejected on the same trajectory. The rule is
        # NaN/inf-safe as-is: sy=NaN compares False, and sy=+inf forces
        # yy=+inf (inf > inf is False).
        sv = x_new - s.x
        yv = g_new - s.g
        sy = jnp.vdot(sv, yv)
        yy = jnp.vdot(yv, yv)
        accept = progress & (sy > eps_curv * yy)
        # N&W eq. 6.20: rescale the first H (after init or a restart) to
        # (s·y / y·y) I before updating, so the estimate starts at the
        # right scale
        gamma = jnp.where(yy > 0, sy / yy, 1.0).astype(dtype)
        H_base = jnp.where(accept & (n_upd == 0), gamma * eye, H)
        rho = jnp.where(sy > 0, 1.0 / sy, 0.0).astype(dtype)
        Hy = H_base @ yv
        yHy = jnp.vdot(yv, Hy)
        H_upd = (
            H_base
            - rho * (jnp.outer(sv, Hy) + jnp.outer(Hy, sv))
            + (rho * rho * yHy + rho) * jnp.outer(sv, sv)
        )
        H_new = jnp.where(accept, H_upd, H)
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
                print(f"  BFGS iter {int(it)}/{maxiters} logp={float(fx):.4g}")

            jax.lax.cond(
                (it_new % progress_every) == 0,
                lambda args: jax.debug.callback(_report, *args),
                lambda args: None,
                (it_new, -f_new),
            )

        return _BFGSState(
            it=it_new,
            x=jnp.where(progress, x_new, s.x),
            f=jnp.where(progress, f_new, s.f),
            g=jnp.where(progress, g_new, s.g),
            H=jnp.where(progress, H_new, s.H),
            n_updates=n_upd + jnp.where(accept, 1, 0),
            nev=nev,
            nrej=nrej,
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
