"""The optimizer loop structure is pluggable through PathfinderConfig
(the reference's pluggable-optimizer axis, ``src/singlepath.jl:120-123``)."""

import numpy as np
import pytest
import jax

from pathfinder_tpu.models import StandardNormal
from pathfinder_tpu.singlepath import pathfinder


def test_line_search_variants_reach_same_optimum():
    target = StandardNormal(4)
    for ls in ["hager_zhang", "more_thuente", "wolfe"]:
        res = pathfinder(
            target, key=jax.random.key(0), maxiters=30, line_search=ls
        )
        assert res.success, ls
        np.testing.assert_allclose(
            res.fit_distribution.mean, np.zeros(4), atol=1e-6, err_msg=ls
        )


def test_cg_optimizer_standard_normal_recovery():
    """optimizer="cg" (PR+ nonlinear CG) through the full driver: exact
    standard-normal recovery, the reference's any-optimizer acceptance
    (``test/optimize.jl:104-135`` runs ConjugateGradient through the same
    pipeline)."""
    target = StandardNormal(5)
    res = pathfinder(
        target, key=jax.random.key(0), maxiters=30, optimizer="cg",
        ndraws=100,
    )
    assert res.success
    np.testing.assert_allclose(
        res.fit_distribution.mean, np.zeros(5), atol=1e-5
    )
    # covariance of the winning fit ≈ I (the trace-derived L-BFGS fits
    # only depend on the trajectory, whatever optimizer produced it)
    cov = np.asarray(res.fit_distribution.cov.to_dense())
    np.testing.assert_allclose(cov, np.eye(5), atol=1e-4)


def test_cg_trace_contract():
    """minimize_cg_trace emits the same OptimizationTrace contract as the
    L-BFGS driver: logp view, index 0 = init, valid-count, monotone
    increase in logp along accepted iterates."""
    import jax.numpy as jnp

    from pathfinder_tpu.ops.cg import minimize_cg_trace

    def logp(x):
        return -0.5 * jnp.sum((x - 1.0) ** 2) * 3.0

    x0 = jnp.asarray(np.full(6, -2.0), jnp.float32)
    trace = minimize_cg_trace(
        jax.value_and_grad(logp), x0, maxiters=40
    )
    nv = int(trace.num_valid)
    assert nv >= 2
    np.testing.assert_allclose(np.asarray(trace.xs[0]), np.asarray(x0))
    lps = np.asarray(trace.log_densities[:nv])
    assert np.all(np.diff(lps) > -1e-6)  # line search enforces decrease of -logp
    np.testing.assert_allclose(
        np.asarray(trace.xs[nv - 1]), np.ones(6), atol=1e-4
    )
    assert int(trace.num_fn_evals) >= nv


def test_cg_on_correlated_gaussian():
    """CG on an ill-conditioned quadratic still yields a usable fit
    (it takes more iterations than L-BFGS; the fit stage's trace-derived
    inverse-Hessians do the rest)."""
    from pathfinder_tpu.models import CorrelatedGaussian

    target = CorrelatedGaussian(8, seed=1)
    res = pathfinder(
        target, key=jax.random.key(2), maxiters=120, optimizer="cg",
        ndraws_elbo=50,
    )
    assert res.success
    np.testing.assert_allclose(
        np.asarray(res.fit_distribution.mean), target.mean, atol=0.05
    )


def test_bfgs_optimizer_standard_normal_recovery():
    """optimizer="bfgs" (dense inverse-Hessian BFGS, the reference's
    Optim.BFGS analog from its any-optimizer test set,
    ``test/optimize.jl:104-110``) through the full driver."""
    target = StandardNormal(5)
    res = pathfinder(
        target, key=jax.random.key(0), maxiters=30, optimizer="bfgs",
        ndraws=100,
    )
    assert res.success
    np.testing.assert_allclose(
        res.fit_distribution.mean, np.zeros(5), atol=1e-5
    )
    cov = np.asarray(res.fit_distribution.cov.to_dense())
    np.testing.assert_allclose(cov, np.eye(5), atol=1e-4)


def test_bfgs_trace_contract_and_quadratic_convergence():
    """minimize_bfgs_trace honors the shared trace contract and, on a
    correlated quadratic, converges to the optimum with the dense-BFGS
    step quality (few iterations, final unit steps)."""
    import jax.numpy as jnp

    from pathfinder_tpu.models import CorrelatedGaussian
    from pathfinder_tpu.ops.bfgs import minimize_bfgs_trace

    target = CorrelatedGaussian(8, seed=3)
    x0 = jnp.asarray(np.full(8, 2.0), jnp.float32)
    trace = minimize_bfgs_trace(
        target.value_and_grad, x0, maxiters=60
    )
    nv = int(trace.num_valid)
    assert 2 <= nv <= 40  # dense BFGS: superlinear, far under the cap
    np.testing.assert_allclose(np.asarray(trace.xs[0]), np.asarray(x0))
    lps = np.asarray(trace.log_densities[:nv])
    assert np.all(np.diff(lps) > -1e-5)
    np.testing.assert_allclose(
        np.asarray(trace.xs[nv - 1]), target.mean, atol=1e-3
    )
    # the trace's gradient rows are the target's gradients at the iterates
    g_last = np.asarray(target.value_and_grad(trace.xs[nv - 1])[1])
    np.testing.assert_allclose(
        np.asarray(trace.gradients[nv - 1]), g_last, rtol=1e-5, atol=1e-6
    )
    assert int(trace.num_fn_evals) >= nv
    assert int(trace.num_bfgs_updates_rejected) == 0  # convex quadratic


def test_bfgs_small_scale_gradient_semantics():
    """The dense-BFGS driver shares the gradient-scale-aware gtol clamp
    with L-BFGS/CG: a small-scaled target must optimize."""
    import jax.numpy as jnp

    from pathfinder_tpu.ops.bfgs import minimize_bfgs_trace

    scale = 1e-7

    def vg(x):
        return scale * (-0.5 * jnp.sum(x * x)), scale * (-x)

    x0 = jnp.full((5,), 2.0, jnp.float32)
    trace = minimize_bfgs_trace(vg, x0, maxiters=50, gtol=1e-10)
    assert int(trace.num_valid) > 2
    last = int(trace.num_valid) - 1
    assert np.abs(np.asarray(trace.xs[last])).max() < 1e-2


def test_newton_optimizer_order2_capability():
    """optimizer="newton" consumes the protocol's order-2 capability
    (hess=; reference LogDensityProblems order 0/1/2, src/optimize.jl:1-33)
    and converges in ONE iteration on a quadratic — exact recovery with
    the minimum 2-point trajectory."""
    import jax.numpy as jnp

    target = StandardNormal(5)
    res = pathfinder(
        target, key=jax.random.key(0), maxiters=30, optimizer="newton",
        ndraws=50,
    )
    assert res.success
    assert int(res.optim_trace.num_valid) == 2  # quadratic: one Newton step
    np.testing.assert_allclose(
        res.fit_distribution.mean, np.zeros(5), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(res.fit_distribution.cov.to_dense()), np.eye(5), atol=1e-5
    )
    # explicit analytic hess= flows through the protocol and the driver
    calls = []

    def hess(x):
        calls.append(1)
        return -jnp.eye(5)

    res2 = pathfinder(
        lambda x: -0.5 * jnp.sum(x * x), dim=5, key=jax.random.key(0),
        optimizer="newton", hess=hess, ndraws=50,
    )
    assert res2.success and calls  # the user Hessian was traced
    # indefinite-Hessian region (nonconvex target): the spectrum clamp
    # keeps every step a descent direction
    def banana(x):
        return -0.5 * (x[0] ** 2 / 4.0 + (x[1] - x[0] ** 2 / 2.0) ** 2)

    res3 = pathfinder(
        banana, dim=2, key=jax.random.key(2), optimizer="newton",
        maxiters=60,
    )
    assert res3.success
    lps = np.asarray(
        res3.optim_trace.log_densities[: int(res3.optim_trace.num_valid)]
    )
    assert np.all(np.diff(lps) > -1e-6)  # monotone ascent
    # hess= with a transform is rejected (the unconstrained Hessian needs
    # the bijector chain rule)
    from pathfinder_tpu.integrations.transforms import Exp, Stacked

    with pytest.raises(ValueError, match="hess= cannot be combined"):
        pathfinder(
            lambda x: jnp.sum(jnp.log(x) - x), dim=2,
            key=jax.random.key(0), optimizer="newton",
            hess=lambda x: -jnp.eye(2), transform=Stacked(((Exp(), 2),)),
        )


def test_newton_escapes_saddle_with_bounded_steps():
    """Near a saddle the Hessian is indefinite; the saddle-free |λ|
    modification must produce BOUNDED descent steps (clamping λ→δ would
    amplify the negative-curvature component by 1/δ ≈ 1e8, a step the
    line search cannot recover — the trajectory silently died there)."""
    import jax.numpy as jnp

    from pathfinder_tpu.ops.newton import minimize_newton_trace

    def logp(x):  # minima of -logp at x2 = ±1; saddle at the origin
        return -(0.5 * x[0] ** 2 - 0.5 * x[1] ** 2 + 0.25 * x[1] ** 4)

    vg = jax.value_and_grad(logp)
    hess = jax.hessian(logp)
    x0 = jnp.asarray([0.1, 0.01])  # near the saddle, tiny x2 gradient
    trace = minimize_newton_trace(vg, x0, hess=hess, maxiters=60)
    n = int(trace.num_valid)
    assert n >= 3  # made real progress, not a dead first line search
    x_end = np.asarray(trace.xs[n - 1])
    assert abs(abs(x_end[1]) - 1.0) < 1e-3  # reached a minimum
    assert abs(x_end[0]) < 1e-3
    lps = np.asarray(trace.log_densities[:n])
    assert np.all(np.diff(lps) > -1e-9)  # monotone ascent throughout


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        pathfinder(
            StandardNormal(2), key=jax.random.key(0), maxiters=10,
            optimizer="adam",
        )


def test_backtracking_line_search_option():
    target = StandardNormal(4)
    res = pathfinder(
        target, key=jax.random.key(1), maxiters=60, line_search="backtracking"
    )
    assert res.success
    np.testing.assert_allclose(
        res.fit_distribution.mean, np.zeros(4), atol=1e-4
    )


def test_unknown_line_search_raises():
    import pytest as _pytest

    with _pytest.raises(ValueError, match="unknown line_search"):
        pathfinder(
            StandardNormal(2), key=jax.random.key(0), maxiters=10,
            line_search="exact",
        )


@pytest.mark.parametrize("opt", ["bfgs", "newton"])
def test_lazy_replay_properties_under_new_optimizers(opt):
    """The lazy fit_distributions / elbo_estimates replay reconstructs
    from the TRACE, whatever optimizer produced it — verify index-for-
    index agreement with the stored core outputs for the dense-BFGS and
    Newton trajectories (previously only lbfgs/cg traces were replayed)."""
    from pathfinder_tpu.models import CorrelatedGaussian

    r = pathfinder(
        CorrelatedGaussian(4, seed=2), key=jax.random.key(1),
        optimizer=opt, maxiters=40, ndraws=20,
    )
    ev = np.asarray(r.elbo_values)
    est = r.elbo_estimates
    mask = ~np.isnan(ev)
    assert mask.any()
    np.testing.assert_allclose(np.asarray(est.value)[mask], ev[mask], rtol=1e-5)
    # NaN-mask agreement between stored and replayed stats
    assert (np.isnan(np.asarray(est.value)) == ~mask).all()
    w = jax.tree_util.tree_map(
        lambda leaf: leaf[r.fit_iteration], r.fit_distributions
    )
    np.testing.assert_allclose(
        np.asarray(w.mean), np.asarray(r.fit_distribution.mean), rtol=1e-6
    )


# ---------------------------------------------------------------------------
# user-supplied optimizer callables (reference parity: ANY Optimization.jl
# optimizer is accepted, src/singlepath.jl:120-123, and the suite plugs in
# a foreign NLopt optimizer, test/optimize.jl:104-135)
# ---------------------------------------------------------------------------


def _gradient_ascent_trace(
    value_and_grad, x0, maxiters=1000, **_ignored_driver_kwargs
):
    """Trivial foreign optimizer: fixed-step gradient ascent emitting the
    shared OptimizationTrace contract (ops/optimizers.py docstring)."""
    import jax.numpy as jnp
    from jax import lax

    from pathfinder_tpu.ops.lbfgs import OptimizationTrace

    f0, g0 = value_and_grad(x0)

    def step(carry, _):
        x, _, g = carry
        x_new = x + 0.5 * g
        f_new, g_new = value_and_grad(x_new)
        return (x_new, f_new, g_new), (x_new, f_new, g_new)

    _, (xs, fs, gs) = lax.scan(step, (x0, f0, g0), None, length=maxiters)
    return OptimizationTrace(
        xs=jnp.concatenate([x0[None], xs]),
        log_densities=jnp.concatenate([f0[None], fs]),
        gradients=jnp.concatenate([g0[None], gs]),
        num_valid=jnp.asarray(maxiters + 1),
        num_bfgs_updates_rejected=jnp.asarray(0),
        num_fn_evals=jnp.asarray(maxiters + 1),
        num_ls_exhausted=jnp.asarray(0),
    )


def test_user_supplied_optimizer_single_path():
    """optimizer=<callable> runs the full single-path pipeline: the fit /
    ELBO / draw stages consume only the trace."""
    target = StandardNormal(4)
    res = pathfinder(
        target, key=jax.random.key(0), maxiters=40,
        optimizer=_gradient_ascent_trace, ndraws=50,
    )
    assert res.success
    assert int(res.optim_trace.num_valid) == 41  # the foreign trace shape
    np.testing.assert_allclose(
        np.asarray(res.fit_distribution.mean), np.zeros(4), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(res.fit_distribution.cov.to_dense()), np.eye(4), atol=1e-3
    )


def test_user_supplied_optimizer_multipath_and_auto():
    """The callable plugs into multipathfinder directly and as an
    auto_optimizers candidate alongside built-in names."""
    from pathfinder_tpu.multipath import multipathfinder

    target = StandardNormal(3)
    res = multipathfinder(
        target, 40, key=jax.random.key(1), nruns=4, maxiters=25,
        optimizer=_gradient_ascent_trace,
    )
    assert np.asarray(res.states.success).all()
    assert np.isfinite(np.asarray(res.draws)).all()

    res_auto = multipathfinder(
        target, 40, key=jax.random.key(1), nruns=4, maxiters=25,
        optimizer="auto", auto_optimizers=("lbfgs", _gradient_ascent_trace),
    )
    assert np.isfinite(np.asarray(res_auto.draws)).all()


def test_optimizer_registry_rejects_non_callable():
    with pytest.raises(TypeError, match="optimizer must be"):
        pathfinder(
            StandardNormal(2), key=jax.random.key(0), maxiters=10,
            optimizer=3,
        )


def test_newton_large_dim_warns():
    """The derived-Hessian Newton path warns at runtime
    when it will materialize a (d, d) Hessian at large d."""
    from pathfinder_tpu.models.protocol import as_log_density
    from pathfinder_tpu.ops.optimizers import resolve_optimizer

    import jax.numpy as jnp

    target = as_log_density(lambda x: -0.5 * jnp.sum(x * x), dim=2500)
    with pytest.warns(UserWarning, match="optimizer='newton' at d=2500"):
        resolve_optimizer("newton", target, dim=2500)
    # below the threshold: silent
    import warnings as _w

    small = as_log_density(lambda x: -0.5 * jnp.sum(x * x), dim=10)
    with _w.catch_warnings():
        _w.simplefilter("error")
        resolve_optimizer("newton", small, dim=10)
