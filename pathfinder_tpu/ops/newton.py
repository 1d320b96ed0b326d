"""Modified-Newton with trajectory trace — the order-2 member of the
pluggable-optimizer axis.

The reference's input protocol carries capability order 0/1/2 and its
optim-function builder wires user Hessians through for optimizers that
want them (``src/optimize.jl:1-33``); this module is the consumer here:
``optimizer="newton"`` uses ``LogDensity.hess`` (or derives it
with ``jax.hessian``) for a modified-Newton step. Emits the identical
:class:`~pathfinder_tpu.ops.lbfgs.OptimizationTrace` contract as the
other drivers — the Woodbury-fit / ELBO / draw stages consume only the
trace.

Algorithm: eigenvalue-modification Newton (Nocedal & Wright 2006
§3.4): ``H_min = -∇²logp`` is eigendecomposed and its spectrum clamped to
``δ = √eps · max(|λ|_max, 1)`` — negative-curvature directions become
mildly positive instead of being followed uphill — then
``p = -V diag(1/λ_mod) Vᵀ g``, a guaranteed descent direction, with the
shared line searches starting from the Newton natural step α₀ = 1. One
(d, d) ``eigh`` per iteration: O(d³) — the moderate-``d`` option (same
envelope as the Hessian itself), with quadratic local convergence that
the quasi-Newton drivers cannot match.

Shares every stopping/abort semantic with the L-BFGS / CG / BFGS drivers.
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
    resolve_c1,
    resolve_line_search,
)

__all__ = ["minimize_newton_trace"]


class _NewtonState(NamedTuple):
    it: jax.Array
    x: jax.Array
    f: jax.Array  # minimization objective (-logp)
    g: jax.Array  # minimization gradient
    nev: jax.Array
    nexh: jax.Array
    done: jax.Array
    xs: jax.Array
    fs: jax.Array
    gs: jax.Array


def minimize_newton_trace(
    value_and_grad: Callable,
    x0: jax.Array,
    hess: Callable = None,
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
    """Maximize ``logp`` with modified Newton, recording the trajectory.

    ``hess(x) -> (d, d)`` is the Hessian of **logp** (maximization view);
    required — the driver supplies ``LogDensity.hess`` or a cached
    ``jax.hessian``. Same contract, conventions, and stopping/abort
    semantics as the other trajectory drivers.
    ``num_bfgs_updates_rejected`` is 0 — Newton keeps no curvature pairs;
    the fit stage re-derives its own guarded L-BFGS history from the
    trace.
    """
    if hess is None:
        raise ValueError(
            "minimize_newton_trace requires hess (the driver passes "
            "LogDensity.hess or a cached jax.hessian)"
        )
    d = x0.shape[0]
    dtype = x0.dtype
    gtol_user = float(gtol)
    ftol_rel = float(ftol) * float(jnp.finfo(dtype).eps) if ftol > 0 else 0.0
    ls_fn = resolve_line_search(line_search)
    c1 = resolve_c1(c1, line_search)
    import math

    sqrt_eps = math.sqrt(float(jnp.finfo(dtype).eps))

    def neg_vg(x):
        lp, glp = value_and_grad(x)
        return (-lp).astype(dtype), (-glp).astype(dtype)

    f0, g0 = neg_vg(x0)
    gtol = scale_aware_gtol(gtol_user, g0, dtype)
    init_abort = should_abort_nonfinite(-f0, -g0, fail_on_nonfinite)

    xs = jnp.zeros((maxiters + 1, d), dtype).at[0].set(x0)
    fs = jnp.zeros((maxiters + 1,), dtype).at[0].set(-f0)
    gs = jnp.zeros((maxiters + 1, d), dtype).at[0].set(-g0)

    state = _NewtonState(
        it=jnp.asarray(0),
        x=x0,
        f=f0,
        g=g0,
        nev=jnp.asarray(1),
        nexh=jnp.asarray(0),
        done=init_abort,
        xs=xs,
        fs=fs,
        gs=gs,
    )

    def cond(s: _NewtonState):
        return (~s.done) & (s.it < maxiters)

    def body(s: _NewtonState):
        H_min = (-hess(s.x)).astype(dtype)
        H_min = 0.5 * (H_min + H_min.T)  # eigh wants exact symmetry
        w, V = jnp.linalg.eigh(H_min)
        # saddle-free spectrum modification: |λ| floored at δ. Clamping
        # λ → max(λ, δ) instead would AMPLIFY negative-curvature
        # components by 1/δ (≈1e8 in f64) — a step the bounded line
        # search cannot recover, silently truncating the trajectory at
        # saddles. |λ| keeps every step O(1/|λ|) and still flips
        # negative curvature into descent (Dauphin et al. 2014; the
        # sign-flip variant of N&W §3.4's indefinite-Hessian fix).
        wmax = jnp.max(jnp.abs(w))
        delta = sqrt_eps * jnp.maximum(wmax, 1.0)
        w_mod = jnp.maximum(jnp.abs(w), delta)
        direction = -(V @ ((V.T @ s.g) / w_mod))
        # a non-finite Hessian poisons the direction: fall back to
        # steepest descent for this step
        dir_ok = jnp.all(jnp.isfinite(direction))
        direction = jnp.where(dir_ok, direction, -s.g)
        dphi0 = jnp.vdot(s.g, direction)
        bad_dir = ~(dphi0 < 0)
        direction = jnp.where(bad_dir, -s.g, direction)

        # Newton natural step: alpha0 = 1 from the first iteration
        ls = ls_fn(
            neg_vg, s.x, s.f, s.g, direction, jnp.ones((), dtype),
            c1=c1, c2=c2, max_evals=max_ls_evals,
        )
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
                print(
                    f"  Newton iter {int(it)}/{maxiters} logp={float(fx):.4g}"
                )

            jax.lax.cond(
                (it_new % progress_every) == 0,
                lambda args: jax.debug.callback(_report, *args),
                lambda args: None,
                (it_new, -f_new),
            )

        return _NewtonState(
            it=it_new,
            x=jnp.where(progress, x_new, s.x),
            f=jnp.where(progress, f_new, s.f),
            g=jnp.where(progress, g_new, s.g),
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
