"""Target log-density protocol.

The JAX analog of the reference's ``LogDensityProblems`` input interface
(``src/optimize.jl:1-33``, ``src/singlepath.jl:142-152``): a target exposes a
dimension, a log density, and optionally its gradient; when no gradient is
provided, ``jax.value_and_grad`` plays the role of the reference's default
ForwardDiff AD backend (``src/Pathfinder.jl:38`` — reverse mode is the right
default here, as the reference's own docs recommend for high dimensions,
``docs/src/examples/quickstart.md:240-241``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax

__all__ = ["LogDensity", "as_log_density", "from_pytree_logp", "PytreeTarget"]


def cached_value_and_grad(logp: Callable) -> Callable:
    """``jax.value_and_grad`` with a stable identity per ``logp``: consumers
    that pass the result as a jit *static* argument (the HMC/NUTS samplers)
    would otherwise recompile on every call, since each
    ``jax.value_and_grad(f)`` invocation returns a fresh function object.

    The derived function is cached as an attribute *on* ``logp`` (not in a
    module-level table) so its lifetime — and that of any arrays the
    closure captures — is exactly the target's own."""
    vg = getattr(logp, "_pf_cached_vg", None)
    if vg is None:
        vg = jax.value_and_grad(logp)
        try:
            logp._pf_cached_vg = vg
        except (AttributeError, TypeError):
            pass  # no __dict__ (e.g. functools.partial): uncached
    return vg


def cached_hessian(logp: Callable) -> Callable:
    """``jax.hessian`` with a stable identity per ``logp`` (same jit-cache
    rationale and on-object lifetime as :func:`cached_value_and_grad`)."""
    h = getattr(logp, "_pf_cached_hess", None)
    if h is None:
        h = jax.hessian(logp)
        try:
            logp._pf_cached_hess = h
        except (AttributeError, TypeError):
            pass
    return h


@dataclasses.dataclass(frozen=True)
class LogDensity:
    """A target distribution: ``logp`` must be JAX-traceable over ``(dim,)``
    arrays. ``value_and_grad`` returns ``(logp(x), ∇logp(x))``. ``hess``
    (optional, ``x -> (d, d)`` Hessian of logp) is the order-2 capability
    of the reference's LogDensityProblems protocol
    (``src/optimize.jl:1-29``) — consumed by ``optimizer="newton"``;
    absent, that optimizer derives it with ``jax.hessian``."""

    logp: Callable
    dim: Optional[int] = None
    value_and_grad: Callable = None  # filled in __post_init__ if absent
    hess: Optional[Callable] = None

    def __post_init__(self):
        if self.value_and_grad is None:
            object.__setattr__(self, "_vg_derived", True)
            object.__setattr__(
                self, "value_and_grad", cached_value_and_grad(self.logp)
            )
        else:
            object.__setattr__(self, "_vg_derived", False)

    # hash/eq ignore a *derived* value_and_grad (it is a fresh closure per
    # instance): two LogDensity objects over the same logp must be jit-cache
    # equal, or every pathfinder() call recompiles the core.
    def _key(self):
        vg = None if self._vg_derived else self.value_and_grad
        return (self.logp, self.dim, vg, self.hess)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, LogDensity) and self._key() == other._key()

    def with_dim(self, dim) -> "LogDensity":
        """Copy with ``dim`` filled in. A derived ``value_and_grad`` is
        re-derived (not copied as if explicit) so the result hashes equal
        to a directly-constructed ``LogDensity(logp, dim)`` — mixing the
        two construction paths must not split the jit cache."""
        if self._vg_derived:
            return LogDensity(logp=self.logp, dim=dim, hess=self.hess)
        return dataclasses.replace(self, dim=dim)


def as_log_density(fn, dim=None, grad=None, hess=None) -> LogDensity:
    """Coerce user input into a :class:`LogDensity`.

    Accepts (mirroring the reference's input dispatch,
    ``src/singlepath.jl:142-152``):

    * a :class:`LogDensity` (returned as-is, ``dim`` filled if missing);
    * any object with ``logp`` and ``dim`` attributes (and optionally
      ``value_and_grad`` / ``logp_and_grad``) — the LogDensityProblems analog;
    * a plain callable ``logp(x) -> float`` (gradient via ``jax.grad`` unless
      ``grad`` is supplied).
    """
    if isinstance(fn, LogDensity):
        if hess is not None and fn.hess is not hess:
            # the explicit argument wins (same precedence as the
            # duck-typed branch). Rebuild rather than replace() when vg
            # is derived: replace() would pass the derived closure as
            # explicit, flipping _vg_derived and splitting the jit-cache
            # hash from the plain-callable construction path (the
            # with_dim invariant).
            if fn._vg_derived:
                fn = LogDensity(logp=fn.logp, dim=fn.dim, hess=hess)
            else:
                fn = dataclasses.replace(fn, hess=hess)
        if dim is not None and fn.dim is None:
            return fn.with_dim(dim)
        return fn
    if hasattr(fn, "logp"):
        logp = fn.logp
        # a present-but-None dim attribute must not shadow the caller's dim
        d = fn.dim if getattr(fn, "dim", None) is not None else dim
        vg = getattr(fn, "value_and_grad", None) or getattr(
            fn, "logp_and_grad", None
        )
        if vg is None and grad is not None:
            vg = _vg_from_parts(logp, grad)
        h = hess if hess is not None else getattr(fn, "hess", None)
        return LogDensity(logp=logp, dim=d, value_and_grad=vg, hess=h)
    if callable(fn):
        vg = _vg_from_parts(fn, grad) if grad is not None else None
        return LogDensity(logp=fn, dim=dim, value_and_grad=vg, hess=hess)
    raise TypeError(f"cannot interpret {type(fn)!r} as a log density")


def _callable_key(f):
    """Identity key that is stable across attribute accesses. Bound
    methods are re-created on every ``obj.method`` access, so keying (or
    caching) on the method object itself never hits; key on the
    (instance, function) pair instead. The ids stay valid because the
    cached closure keeps the original callable — and hence both id'd
    objects — alive."""
    self_ = getattr(f, "__self__", None)
    func = getattr(f, "__func__", None)
    if self_ is not None and func is not None:
        return (id(self_), id(func))
    return id(f)


def _vg_from_parts(logp, grad):
    # cached on the logp object (or, for a bound method, on its instance —
    # methods have no __dict__ and fresh identity per access), keyed by
    # grad identity: repeated pathfinder(fn, grad=g) calls must produce
    # the same LogDensity hash (vg is part of _key when explicit) or the
    # jitted core recompiles every call
    owner = getattr(logp, "__self__", logp)
    key = (_callable_key(logp), _callable_key(grad))
    cache = getattr(owner, "_pf_vg_parts", None)
    if cache is not None and cache[0] == key:
        return cache[1]

    def value_and_grad(x):
        return logp(x), grad(x)

    try:
        owner._pf_vg_parts = (key, value_and_grad)
    except (AttributeError, TypeError):
        pass  # no __dict__: uncached
    return value_and_grad


def from_pytree_logp(logp_tree: Callable, example_params) -> "PytreeTarget":
    """Adapt a log density over a parameter *pytree* to the flat-vector
    interface (the idiom PPL-style models use).

    ``logp_tree(params)`` takes a pytree shaped like ``example_params``.
    Returns a :class:`PytreeTarget` whose ``.target`` is a flat
    :class:`LogDensity` for ``pathfinder``/``multipathfinder``, plus
    ``unravel``/``ravel`` to move results back and forth.
    """
    from jax.flatten_util import ravel_pytree

    flat0, unravel = ravel_pytree(example_params)

    def logp(x):
        return logp_tree(unravel(x))

    target = LogDensity(logp=logp, dim=int(flat0.shape[0]))
    return PytreeTarget(target=target, unravel=unravel, example_flat=flat0)


@dataclasses.dataclass(frozen=True)
class PytreeTarget:
    """Flat-vector view of a pytree-parameterized log density."""

    target: LogDensity
    unravel: Callable
    example_flat: "jax.Array"

    def ravel(self, params):
        from jax.flatten_util import ravel_pytree

        return ravel_pytree(params)[0]

    def unravel_draws(self, draws):
        """Map a ``(dim, ndraws)`` draw matrix to a pytree with a leading
        draws axis on every leaf."""
        import jax as _jax

        return _jax.vmap(self.unravel, in_axes=1)(draws)
