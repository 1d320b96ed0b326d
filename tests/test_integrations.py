"""Integration-layer tests.

Ports the strategy of the reference's integration suites: Woodbury-metric ≡
dense-metric identities (``test/integration/DynamicHMC/runtests.jl:57-73``,
``test/integration/AdvancedHMC/runtests.jl:69-131``), warm-started sampling
recovering posterior moments (``:133-226``), and transform/Jacobian
correctness + exact recovery of transformed IID normals
(``test/integration/Turing/runtests.jl:43-64,179-204``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy import stats

from pathfinder_tpu.integrations.hmc import WoodburyMetric, hmc, hmc_warm_start, leapfrog
from pathfinder_tpu.integrations.transforms import (
    Exp,
    Identity,
    Interval,
    Stacked,
    TransformedLogDensity,
)
from pathfinder_tpu.models import CorrelatedGaussian, StandardNormal
from pathfinder_tpu.ops.mvnormal import MvNormal
from pathfinder_tpu.ops.woodbury import WoodburyPDMat
from pathfinder_tpu.singlepath import pathfinder


def make_metric(rng, n=6, m=4):
    A = rng.uniform(0.5, 2.0, n)
    B = (rng.standard_normal((n, m)) / np.sqrt(n))
    U = np.linalg.qr(rng.standard_normal((m, m)))[0]
    D = U @ np.diag(rng.uniform(0.5, 2.0, m)) @ U.T
    W = WoodburyPDMat.from_parts(A, B, D)
    W_dense = np.diag(A) + B @ D @ B.T
    return WoodburyMetric(W), W_dense


def test_metric_matches_dense():
    """Kinetic energy / gradient / momentum distribution of the low-rank
    metric must equal the dense metric's (reference DynamicHMC/AdvancedHMC
    equivalence tests)."""
    rng = np.random.default_rng(0)
    metric, W_dense = make_metric(rng)
    M_dense = np.linalg.inv(W_dense)  # mass matrix

    p = rng.standard_normal(6)
    np.testing.assert_allclose(
        metric.kinetic_energy(jnp.asarray(p)), 0.5 * p @ W_dense @ p, rtol=1e-9
    )
    np.testing.assert_allclose(
        metric.grad_kinetic(jnp.asarray(p)), W_dense @ p, rtol=1e-9
    )

    # momentum draws have covariance M = W⁻¹
    keys = jax.random.split(jax.random.key(1), 200_000)
    ps = jax.vmap(metric.sample_momentum)(keys)
    emp_cov = np.cov(np.asarray(ps).T)
    np.testing.assert_allclose(emp_cov, M_dense, atol=0.05, rtol=0.1)


def test_warm_start_exports():
    """External-sampler warm-start adapters (the role of
    ``ext/PathfinderAdvancedHMCExt.jl:17-23``): the exported inverse mass
    matrix is the dense fit covariance, and the blackjax Metric (when
    blackjax is available) draws momenta with covariance M = W⁻¹."""
    rng = np.random.default_rng(3)
    metric, W_dense = make_metric(rng)

    # dense export: numpyro-style inverse mass matrix == W
    imm = np.asarray(metric.to_numpyro_mass_matrix())
    np.testing.assert_allclose(imm, W_dense, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(metric.to_inverse_mass_matrix()), W_dense, rtol=1e-6, atol=1e-9
    )

    try:
        import blackjax  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="BlackJAX"):
            metric.to_blackjax()


@pytest.mark.realpkgs
def test_to_blackjax_real():
    """Momentum covariance and kinetic energy of the exported blackjax
    Metric against the dense fit (runs only with real blackjax; the
    contract is otherwise pinned by ``test_to_blackjax_contract_with_mock``)."""
    pytest.importorskip("blackjax", reason="BlackJAX not installed")
    rng = np.random.default_rng(3)
    metric, W_dense = make_metric(rng)
    bj = metric.to_blackjax()
    keys = jax.random.split(jax.random.key(2), 100_000)
    ps = jax.vmap(bj.sample_momentum)(keys)
    emp_cov = np.cov(np.asarray(ps).T)
    np.testing.assert_allclose(
        emp_cov, np.linalg.inv(W_dense), atol=0.05, rtol=0.15
    )
    p = jnp.asarray(rng.standard_normal(6))
    np.testing.assert_allclose(
        float(bj.kinetic_energy(p)),
        0.5 * np.asarray(p) @ W_dense @ np.asarray(p),
        rtol=1e-6,
    )


def test_to_blackjax_contract_with_mock(monkeypatch):
    """Exercise ``to_blackjax`` against a mock of blackjax's
    ``mcmc.metrics.Metric`` container (blackjax cannot
    be installed here — zero egress). Pins (a) the Metric NamedTuple layout
    ``(sample_momentum, kinetic_energy, check_turning)``, (b) momentum
    covariance = M = W⁻¹, (c) kinetic energy vs dense, (d) the generalized
    U-turn criterion vs its dense formula. The real-package branch of
    ``test_warm_start_exports`` runs when blackjax is installed."""
    import sys
    import types
    from typing import Callable, NamedTuple

    class Metric(NamedTuple):  # blackjax.mcmc.metrics.Metric layout
        sample_momentum: Callable
        kinetic_energy: Callable
        check_turning: Callable

    fake_metrics = types.ModuleType("blackjax.mcmc.metrics")
    fake_metrics.Metric = Metric
    fake_mcmc = types.ModuleType("blackjax.mcmc")
    fake_mcmc.metrics = fake_metrics
    fake_blackjax = types.ModuleType("blackjax")
    fake_blackjax.mcmc = fake_mcmc
    monkeypatch.setitem(sys.modules, "blackjax", fake_blackjax)
    monkeypatch.setitem(sys.modules, "blackjax.mcmc", fake_mcmc)
    monkeypatch.setitem(sys.modules, "blackjax.mcmc.metrics", fake_metrics)

    rng = np.random.default_rng(5)
    metric, W_dense = make_metric(rng)
    bj = metric.to_blackjax()
    assert isinstance(bj, Metric)

    # (b) momentum covariance ≈ M = W⁻¹, called with the kernel arity:
    # blackjax HMC/NUTS kernels invoke metric.sample_momentum(key, position)
    pos = jnp.zeros(6)
    keys = jax.random.split(jax.random.key(7), 100_000)
    ps = jax.vmap(lambda k: bj.sample_momentum(k, pos))(keys)
    emp_cov = np.cov(np.asarray(ps).T)
    np.testing.assert_allclose(
        emp_cov, np.linalg.inv(W_dense), atol=0.05, rtol=0.15
    )

    # (c) kinetic energy (positional (momentum, position) kernel arity)
    p = rng.standard_normal(6)
    np.testing.assert_allclose(
        float(bj.kinetic_energy(jnp.asarray(p), pos)),
        0.5 * p @ W_dense @ p,
        rtol=1e-6,
    )

    # (d) U-turn criterion against the dense formula on random triples —
    # BlackJAX's convention: rho = p_sum − (p_left + p_right)/2 (its
    # gaussian_euclidean.is_turning), so the Metric is a drop-in for
    # blackjax kernels (trees terminate at the same depths as any
    # blackjax-built metric)
    for i in range(20):
        pl = rng.standard_normal(6)
        pr = rng.standard_normal(6)
        p_sum = pl + pr + rng.standard_normal(6)
        rho = p_sum - 0.5 * (pl + pr)
        expected = (rho @ W_dense @ pl <= 0) or (rho @ W_dense @ pr <= 0)
        got = bool(
            bj.check_turning(
                jnp.asarray(pl), jnp.asarray(pr), jnp.asarray(p_sum)
            )
        )
        assert got == expected, i


def test_leapfrog_zero_steps_raises():
    """n_steps=0 would gather from an empty scan output (undefined under
    jit); it must raise instead."""
    import pytest

    target = StandardNormal(3)
    metric, _ = make_metric(np.random.default_rng(1), n=3, m=2)
    x = jnp.zeros(3)
    _, g = target.value_and_grad(x)
    with pytest.raises(ValueError, match="n_steps must be >= 1"):
        leapfrog(target.value_and_grad, metric, x, jnp.ones(3), g, 0.1, 0)


def test_leapfrog_energy_conservation():
    d = 4
    target = StandardNormal(d)
    rng = np.random.default_rng(2)
    metric, W_dense = make_metric(rng, n=d, m=2)
    x = jnp.asarray(rng.standard_normal(d))
    key = jax.random.key(0)
    p = metric.sample_momentum(key)
    logp0, g0 = target.value_and_grad(x)
    h0 = float(metric.kinetic_energy(p) - logp0)
    x1, p1, logp1, g1 = leapfrog(target.value_and_grad, metric, x, p, g0, 0.01, 100)
    h1 = float(metric.kinetic_energy(p1) - logp1)
    assert abs(h1 - h0) < 1e-3  # near-exact energy conservation at small eps


def test_warm_started_hmc_posterior_agreement():
    """Pathfinder → HMC recovers mean/cov of a correlated Gaussian within
    MC error (the reference's NUTS-agreement tests at rtol 0.1)."""
    d = 5
    target = CorrelatedGaussian(d, seed=3)
    res = pathfinder(
        target, key=jax.random.key(0), ndraws=10, maxiters=80, history_length=d
    )
    assert res.success
    out = hmc_warm_start(
        jax.random.key(1),
        res,
        num_samples=4000,
        num_warmup=500,
        num_leapfrog=8,
    )
    xs = np.asarray(out.samples)
    acc = float(np.mean(np.asarray(out.accept_prob)))
    assert acc > 0.6, f"mean acceptance {acc}"
    # z-test with generous MCSE (correlated samples)
    np.testing.assert_allclose(xs.mean(axis=0), target.mean, atol=0.15)
    np.testing.assert_allclose(np.cov(xs.T), target.cov, atol=0.3, rtol=0.3)


def test_hmc_warm_start_on_transform_aware_result():
    """``hmc_warm_start`` on a BayesModel result must target the linked
    (unconstrained) density — regression test: it used to crash trying to
    interpret the model itself as a log density."""
    import jax.numpy as jnp

    from pathfinder_tpu.models.bayes import BayesModel, HalfNormal, Normal

    obs = jnp.asarray([1.0, 2.0, 0.5, 1.5])
    model = BayesModel(
        {"mu": Normal(0.0, 5.0), "sigma": HalfNormal(2.0)},
        loglikelihood=lambda p: jnp.sum(
            -0.5 * ((obs - p["mu"]) / p["sigma"]) ** 2 - jnp.log(p["sigma"])
        ),
    )
    res = pathfinder(model, key=jax.random.key(0), maxiters=50)
    assert res.success
    out = hmc_warm_start(
        jax.random.key(1), res, num_samples=200, num_warmup=100,
        num_leapfrog=8,
    )
    assert out.samples.shape == (200, 2)
    assert float(np.mean(np.asarray(out.accept_prob))) > 0.5
    # samples are unconstrained; the constrained view must be in-support
    chain = model.draws_to_chain(jnp.asarray(out.samples).T)
    assert np.all(np.asarray(chain["sigma"]) > 0)
    # posterior mean of mu should be near the data mean
    assert abs(float(np.mean(np.asarray(chain["mu"]))) - 1.25) < 0.6

    # nuts_warm_start resolves the same linked target
    from pathfinder_tpu.integrations.nuts import nuts_warm_start

    nres = nuts_warm_start(
        jax.random.key(2), res, num_samples=100, num_warmup=100, max_depth=6
    )
    nchain = model.draws_to_chain(jnp.asarray(nres.samples).T)
    assert np.all(np.asarray(nchain["sigma"]) > 0)
    assert abs(float(np.mean(np.asarray(nchain["mu"]))) - 1.25) < 0.6


def test_warm_start_chains_on_transform_aware_result():
    """``warm_start_chains`` (multi-chain packaging) on a BayesModel
    multipath result: the resolved target must be the linked unconstrained
    density and the inits the unconstrained draws (the recorded lesson:
    every result-consuming entry point gets a transform-aware test)."""
    import jax.numpy as jnp

    from pathfinder_tpu.integrations.nuts import (
        nuts_chains,
        warm_start_chains,
    )
    from pathfinder_tpu.models.bayes import BayesModel, HalfNormal, Normal
    from pathfinder_tpu.multipath import multipathfinder

    obs = jnp.asarray([1.0, 2.0, 0.5, 1.5])
    model = BayesModel(
        {"mu": Normal(0.0, 5.0), "sigma": HalfNormal(2.0)},
        loglikelihood=lambda p: jnp.sum(
            -0.5 * ((obs - p["mu"]) / p["sigma"]) ** 2 - jnp.log(p["sigma"])
        ),
    )
    res = multipathfinder(
        model, 32, key=jax.random.key(5), nruns=4, maxiters=50
    )
    vg, metric, x0s = warm_start_chains(res, 2)
    # the resolved density is the linked one: finite at any real vector
    # (a constrained-space density would be -inf/NaN at sigma <= 0)
    lp, g = vg(jnp.asarray([0.0, -3.0]))
    assert np.isfinite(float(lp)) and np.all(np.isfinite(np.asarray(g)))
    out, summary = nuts_chains(
        jax.random.key(6), vg, metric, x0s,
        num_samples=200, num_warmup=100, max_depth=6,
    )
    # constrained view of every chain is in-support
    flat = jnp.asarray(out.samples).reshape(-1, 2).T
    chain = model.draws_to_chain(flat)
    assert np.all(np.asarray(chain["sigma"]) > 0)
    assert abs(float(np.mean(np.asarray(chain["mu"]))) - 1.25) < 0.6


def test_bijector_jacobians_vs_autodiff():
    z = jnp.asarray(np.random.default_rng(4).standard_normal(5))
    for bij in [Identity(), Exp(), Interval(-1.0, 2.5)]:
        for zi in z:
            expected = jnp.log(jnp.abs(jax.grad(lambda t: bij.forward(t))(zi)))
            got = bij.forward_log_det(zi)
            np.testing.assert_allclose(got, expected, rtol=1e-8)
        # inverse round trip
        np.testing.assert_allclose(bij.inverse(bij.forward(z)), z, rtol=1e-6, atol=1e-8)


def test_stacked_bijector():
    st = Stacked([(Identity(), 2), (Exp(), 1), (Interval(0.0, 1.0), 2)])
    z = jnp.asarray([0.3, -0.5, 1.2, 0.1, -2.0])
    x = st.forward(z)
    assert x.shape == (5,)
    np.testing.assert_allclose(st.inverse(x), z, rtol=1e-6)
    expected = jnp.concatenate(
        [
            jnp.zeros(2),
            z[2:3],
            Interval(0.0, 1.0).forward_log_det(z[3:]),
        ]
    )
    np.testing.assert_allclose(st.forward_log_det(z), expected, rtol=1e-8)


def test_transformed_pathfinder_recovers_lognormal():
    """x ~ LogNormal(μ, σ): in unconstrained space z = log x the target is
    exactly N(μ, σ²), so Pathfinder must recover it to high precision and
    forward_draws must return positive draws (the Turing-ext exact-recovery
    test, ``test/integration/Turing/runtests.jl:179-204``)."""
    mu, sigma = 0.7, 0.5

    def logp_constrained(x):
        # LogNormal density
        return jnp.sum(
            -0.5 * ((jnp.log(x) - mu) / sigma) ** 2
            - jnp.log(x)
            - jnp.log(sigma)
            - 0.5 * jnp.log(2 * jnp.pi)
        )

    tld = TransformedLogDensity(
        logp_constrained=logp_constrained, bijector=Exp(), dim=3
    )
    res = pathfinder(tld.unconstrained, key=jax.random.key(5), ndraws=200, maxiters=50)
    assert res.success
    np.testing.assert_allclose(res.fit_distribution.mean, np.full(3, mu), atol=1e-4)
    np.testing.assert_allclose(
        res.fit_distribution.cov.to_dense(), np.eye(3) * sigma**2, atol=1e-4
    )
    x_draws = tld.forward_draws(res.draws)
    assert np.all(np.asarray(x_draws) > 0)
    # constrained draws are lognormal: check the median roughly
    med = np.median(np.asarray(x_draws))
    assert abs(np.log(med) - mu) < 0.2


def test_warm_start_from_multipath_result():
    """``hmc_warm_start`` / ``nuts_warm_start`` must accept a
    MultiPathfinderResult (the documented resampling→NUTS workflow,
    docs/examples/resampling.md): the metric is the covariance of the
    component that produced the selected draw."""
    from pathfinder_tpu.integrations.nuts import nuts_warm_start
    from pathfinder_tpu.multipath import multipathfinder

    target = CorrelatedGaussian(5, seed=9)
    mres = multipathfinder(
        target, 40, key=jax.random.key(0), nruns=4, maxiters=60,
        history_length=5,
    )
    for di in (0, 7):
        m = WoodburyMetric.from_result(mres, draw_index=di)
        k = int(mres.draw_component_ids[di])
        np.testing.assert_allclose(
            np.asarray(m.minv.to_dense()),
            np.asarray(mres.fit_distribution.component(k).cov.to_dense()),
        )
    out = hmc_warm_start(
        jax.random.key(1), mres, num_samples=400, num_warmup=200
    )
    xs = np.asarray(out.samples)
    assert np.isfinite(xs).all()
    np.testing.assert_allclose(xs.mean(axis=0), target.mean, atol=0.6)
    nout = nuts_warm_start(
        jax.random.key(2), mres, num_samples=200, num_warmup=150, max_depth=6
    )
    assert np.isfinite(np.asarray(nout.samples)).all()
    # out-of-range draw_index raises instead of silently clamping to the
    # last draw (JAX gather semantics would clamp)
    import pytest

    with pytest.raises(IndexError, match="draw_index 40"):
        WoodburyMetric.from_result(mres, draw_index=40)
    with pytest.raises(IndexError):
        WoodburyMetric.from_result(mres, draw_index=-41)
    # negative in-range indices follow Python semantics
    m_last = WoodburyMetric.from_result(mres, draw_index=-1)
    k_last = int(mres.draw_component_ids[-1])
    np.testing.assert_allclose(
        np.asarray(m_last.minv.to_dense()),
        np.asarray(mres.fit_distribution.component(k_last).cov.to_dense()),
    )


def test_zero_warmup_respects_init_step_size():
    """``num_warmup=0`` (use a known-good step size, skip adaptation) must
    sample at ``init_step_size``, not at exp(0)=1."""
    from pathfinder_tpu.integrations.nuts import nuts

    rng = np.random.default_rng(11)
    metric, _ = make_metric(rng, n=3, m=0)
    vg = jax.value_and_grad(lambda x: -0.5 * jnp.sum(x * x))
    out = hmc(
        jax.random.key(0), vg, metric, jnp.zeros(3),
        num_samples=20, num_warmup=0, init_step_size=0.05,
    )
    assert float(out.step_size) == pytest.approx(0.05)
    nout = nuts(
        jax.random.key(1), vg, metric, jnp.zeros(3),
        num_samples=20, num_warmup=0, max_depth=4, init_step_size=0.05,
    )
    assert float(nout.step_size) == pytest.approx(0.05)


def test_stacked_size_mismatch_raises():
    """Block sizes that don't cover the vector must error, not silently
    truncate the parameter vector (dropping gradients and Jacobian terms)."""
    st = Stacked([(Exp(), 3)])
    with pytest.raises(ValueError, match="sum to the target dimension"):
        st.forward(jnp.zeros(5))
    with pytest.raises(ValueError, match="sum to the target dimension"):
        st.forward_log_det(jnp.zeros(2))
    with pytest.raises(ValueError, match=">= 1"):
        Stacked([(Exp(), 0)])


def test_resolve_value_and_grad_stable_identity():
    """Warm-start resolution must return the identical callable across
    calls: it is a static jit argument of hmc/nuts, so a fresh closure per
    call would recompile the whole sampler every time."""
    from pathfinder_tpu.integrations.hmc import resolve_result_value_and_grad

    def logp(x):
        return -0.5 * jnp.sum(x * x)

    res = pathfinder(logp, dim=3, key=jax.random.key(0), ndraws=5, maxiters=20)
    vg1 = resolve_result_value_and_grad(res)
    vg2 = resolve_result_value_and_grad(res)
    assert vg1 is vg2
