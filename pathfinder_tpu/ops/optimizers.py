"""Trajectory-optimizer registry — named built-ins + user callables.

Parity: the reference accepts ANY Optimization.jl-compatible optimizer
with callback support (``src/singlepath.jl:120-123``) and its test suite
plugs in a foreign NLopt optimizer (``test/optimize.jl:104-135``). The
JAX analog is the shared **trace contract**: a trajectory optimizer is
any callable

    minimize(value_and_grad, x0, *, maxiters, history_length, gtol,
             ftol, epsilon_curvature, max_ls_evals, c1, c2,
             fail_on_nonfinite, progress_every, line_search)
        -> OptimizationTrace

(see :func:`pathfinder_tpu.ops.lbfgs.minimize_lbfgs_trace` for the
semantics of every kwarg and of the returned fixed-shape trace; the
``value_and_grad`` argument returns ``(logp(x), ∇logp(x))`` in the
*maximization* view and the trace records logp-view values). The fit /
ELBO / draw stages consume only the trace, so anything honoring the
contract plugs into ``optimizer=`` in both drivers — exactly the
property the reference gets from Optimization.jl's callback interface.

Pass ``optimizer=<callable>`` (the callable must be jit-traceable; its
identity is part of the jit cache key, so reuse one function object
across calls) or one of the registered names below. Extra kwargs a
custom driver does not implement can be accepted and ignored — the four
built-ins do the same for e.g. ``history_length`` where it is
meaningless (CG/Newton).
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Callable, Union

from pathfinder_tpu.ops.lbfgs import minimize_lbfgs_trace

__all__ = [
    "OPTIMIZERS",
    "resolve_optimizer",
    "NEWTON_DENSE_DIM_WARN",
]

# Above this dimension the modified-Newton driver's per-iteration dense
# (d, d) Hessian + eigh (O(d²) memory / O(d³) flops,
# ops/newton.py:130-150) dominates everything else in the pipeline and
# compiles slowly; warn so users reach for a quasi-Newton driver instead
# of waiting on an apparent hang.
NEWTON_DENSE_DIM_WARN = 2000


def _lbfgs(target, dim):
    return minimize_lbfgs_trace


def _cg(target, dim):
    from pathfinder_tpu.ops.cg import minimize_cg_trace

    return minimize_cg_trace


def _bfgs(target, dim):
    from pathfinder_tpu.ops.bfgs import minimize_bfgs_trace

    return minimize_bfgs_trace


def _newton(target, dim):
    from pathfinder_tpu.models.protocol import cached_hessian
    from pathfinder_tpu.ops.newton import minimize_newton_trace

    user_hess = getattr(target, "hess", None)
    hess_fn = user_hess if user_hess is not None else cached_hessian(
        target.logp
    )
    if dim is not None and dim > NEWTON_DENSE_DIM_WARN:
        how = (
            "derives the Hessian with jax.hessian (d reverse-over-forward "
            "passes per iteration)"
            if user_hess is None
            else "calls your hess="
        )
        warnings.warn(
            f"optimizer='newton' at d={dim} {how} and materializes a "
            f"(d, d)={dim}x{dim} matrix plus one dense eigh (O(d^3)) per "
            "iteration — expect long compiles and high memory above "
            f"d~{NEWTON_DENSE_DIM_WARN}. Consider optimizer='lbfgs' or "
            "'cg' (O(d) per iteration) at this scale."
        )
    return partial(minimize_newton_trace, hess=hess_fn)


# name -> factory(target, dim) -> minimize callable. Factories run at
# trace time (host), so they may inspect the target (newton wires the
# order-2 capability) and emit scale warnings.
OPTIMIZERS = {
    "lbfgs": _lbfgs,
    "cg": _cg,
    "bfgs": _bfgs,
    "newton": _newton,
}


def resolve_optimizer(
    optimizer: Union[str, Callable], target, dim=None
) -> Callable:
    """Resolve ``PathfinderConfig.optimizer`` to a minimize callable.

    Strings look up the registry (``'auto'`` is handled a level up, in
    ``multipathfinder`` — a single path has no k̂ selection signal);
    callables pass through untouched (the user-supplied-optimizer path,
    reference parity ``src/singlepath.jl:120-123``).
    """
    if isinstance(optimizer, str):
        if optimizer == "auto":
            raise ValueError(
                "optimizer='auto' is a multipathfinder feature (it selects "
                "by the multipath Pareto-k̂ diagnostic); a single path has "
                "no selection signal — pick one of "
                f"{tuple(OPTIMIZERS)} or pass a callable"
            )
        factory = OPTIMIZERS.get(optimizer)
        if factory is None:
            raise ValueError(
                f"unknown optimizer {optimizer!r}; choose from "
                f"{tuple(OPTIMIZERS)} or pass a callable with the "
                "minimize_*_trace contract (see "
                "pathfinder_tpu.ops.optimizers)"
            )
        return factory(target, dim)
    if callable(optimizer):
        return optimizer
    raise TypeError(
        f"optimizer must be a registered name {tuple(OPTIMIZERS)} or a "
        f"callable with the minimize_*_trace contract; got "
        f"{type(optimizer).__name__}"
    )
