"""Dynamic NUTS tests: posterior recovery, termination behavior, and the
Pathfinder warm-start workflow (the reference's integration-test role,
``test/integration/*/runtests.jl``)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pathfinder_tpu.integrations.hmc import WoodburyMetric
from pathfinder_tpu.integrations.nuts import nuts, nuts_warm_start
from pathfinder_tpu.models import CorrelatedGaussian, NealsFunnel
from pathfinder_tpu.ops.woodbury import WoodburyPDMat
from pathfinder_tpu.singlepath import pathfinder
from pathfinder_tpu.utils.diagnostics import ess_bulk, split_rhat


def identity_metric(d):
    return WoodburyMetric(
        WoodburyPDMat.from_parts(jnp.ones(d), jnp.zeros((d, 0)), jnp.zeros((0, 0)))
    )


def test_nuts_standard_normal():
    d = 4
    vg = jax.value_and_grad(lambda x: -0.5 * jnp.sum(x * x))
    out = nuts(
        jax.random.key(0), vg, identity_metric(d), jnp.ones(d),
        num_samples=3000, num_warmup=400,
    )
    xs = np.asarray(out.samples)
    assert not np.any(np.asarray(out.diverging))
    assert np.abs(xs.mean(axis=0)).max() < 0.12
    np.testing.assert_allclose(xs.var(axis=0), np.ones(d), rtol=0.15)
    # step size adapted to something sensible for a unit Gaussian
    assert 0.3 < float(out.step_size) < 2.5


def test_nuts_correlated_vs_truth():
    d = 5
    target = CorrelatedGaussian(d, seed=11)
    vg = target.value_and_grad
    out = nuts(
        jax.random.key(1), vg, identity_metric(d),
        jnp.asarray(target.mean, jnp.float64),
        num_samples=5000, num_warmup=500,
    )
    xs = np.asarray(out.samples)
    np.testing.assert_allclose(xs.mean(axis=0), target.mean, atol=0.15)
    np.testing.assert_allclose(np.cov(xs.T), target.cov, atol=0.3, rtol=0.35)


def test_nuts_preconditioned_depth_small():
    """With metric == target covariance the trajectory U-turns fast: tree
    depths should be small and sampling near-iid."""
    d = 6
    target = CorrelatedGaussian(d, seed=3)
    # exact covariance as a Woodbury matrix: A = small diag + full-rank B D Bᵀ
    cov = target.cov
    A = np.full(d, 1e-3)
    metric = WoodburyMetric(
        WoodburyPDMat.from_parts(jnp.asarray(A), jnp.eye(d), jnp.asarray(cov - np.diag(A)))
    )
    out = nuts(
        jax.random.key(2), target.value_and_grad, metric,
        jnp.asarray(target.mean), num_samples=3000, num_warmup=400,
    )
    xs = np.asarray(out.samples)
    depths = np.asarray(out.tree_depths)
    assert depths.mean() <= 3.0
    np.testing.assert_allclose(xs.mean(axis=0), target.mean, atol=0.1)
    ess = np.asarray(ess_bulk(jnp.asarray(xs[None])))
    assert ess.min() > 1000  # near-iid given perfect preconditioning


def test_nuts_leapfrog_ledger():
    """n_leapfrogs / warmup_n_leapfrogs are the exact per-transition
    logp+grad eval counts (Stan's n_leapfrog__ analog): positive, bounded
    by the tree-doubling budget 2^depth - 1, and present in both the
    adaptive and fixed-metric warmup branches."""
    d = 3
    vg = jax.value_and_grad(lambda x: -0.5 * jnp.sum(x * x))
    for adapt in (False, True):
        out = nuts(
            jax.random.key(7), vg, None if adapt else identity_metric(d),
            jnp.ones(d), num_samples=200, num_warmup=100,
            adapt_mass_matrix=adapt,
        )
        n_lf = np.asarray(out.n_leapfrogs)
        w_lf = np.asarray(out.warmup_n_leapfrogs)
        depths = np.asarray(out.tree_depths)
        assert n_lf.shape == (200,) and w_lf.shape == (100,)
        assert np.all(n_lf >= 1) and np.all(w_lf >= 1)
        # each doubling at depth j integrates at most 2^j new leaves
        assert np.all(n_lf <= 2 ** depths.astype(np.int64) - 1 + (depths == 0))
        assert np.all(n_lf >= depths)


def test_warm_start_chains_multipath():
    """warm_start_chains packages (vg, metric, x0s) for nuts_chains from a
    multipath result: inits are PSIS draws, the metric is the first
    selected draw's component covariance, and the chains recover the
    target."""
    from pathfinder_tpu.integrations.nuts import (
        nuts_chains,
        warm_start_chains,
    )
    from pathfinder_tpu.multipath import multipathfinder

    d = 5
    target = CorrelatedGaussian(d, seed=4)
    res = multipathfinder(
        target, 64, key=jax.random.key(3), nruns=4, maxiters=60,
        history_length=d,
    )
    vg, metric, x0s = warm_start_chains(res, 4)
    assert x0s.shape == (4, d)
    np.testing.assert_array_equal(
        np.asarray(x0s), np.asarray(res.draws[:, :4].T)
    )
    # metric component matches the first draw's component id
    k0 = int(res.draw_component_ids[0])
    np.testing.assert_array_equal(
        np.asarray(metric.minv.to_dense()),
        np.asarray(res.fit_distribution.component(k0).cov.to_dense()),
    )
    out, summary = nuts_chains(
        jax.random.key(4), vg, metric, x0s,
        num_samples=500, num_warmup=200,
    )
    np.testing.assert_allclose(
        np.asarray(out.samples).reshape(-1, d).mean(0), target.mean,
        atol=0.2,
    )
    assert float(np.max(np.asarray(summary["rhat"]))) < 1.05
    # asking for more chains than draws is a loud error
    with pytest.raises(ValueError, match="chain inits"):
        warm_start_chains(res, 65)
    # EVERY out-of-range index is a loud error (JAX gather would
    # silently clamp index 999 to the last draw), not just the first
    with pytest.raises(IndexError, match="out of range"):
        warm_start_chains(res, 2, draw_indices=[0, 999])
    # wrong-length draw_indices names the actual problem
    with pytest.raises(ValueError, match="draw_indices has 3 entries"):
        warm_start_chains(res, 4, draw_indices=[0, 1, 2])
    # negative indices are accepted python-style (parity with
    # WoodburyMetric.from_result)
    _, _, x0s_neg = warm_start_chains(res, 2, draw_indices=[0, -1])
    np.testing.assert_array_equal(
        np.asarray(x0s_neg[1]), np.asarray(res.draws[:, -1])
    )


def test_nuts_warm_start_from_pathfinder():
    d = 5
    target = CorrelatedGaussian(d, seed=4)
    res = pathfinder(
        target, key=jax.random.key(0), ndraws=10, maxiters=80, history_length=d
    )
    assert res.success
    out = nuts_warm_start(
        jax.random.key(1), res, num_samples=3000, num_warmup=300
    )
    xs = np.asarray(out.samples)
    assert not np.any(np.asarray(out.diverging))
    np.testing.assert_allclose(xs.mean(axis=0), target.mean, atol=0.15)
    np.testing.assert_allclose(np.cov(xs.T), target.cov, atol=0.3, rtol=0.35)
    # multi-chain R-hat
    chains = jax.vmap(
        lambda k, x0: nuts(
            k, target.value_and_grad, WoodburyMetric.from_result(res), x0,
            num_samples=1000, num_warmup=300,
        ).samples
    )(jax.random.split(jax.random.key(2), 4), res.draws[:, :4].T)
    r = np.asarray(split_rhat(jnp.asarray(chains)))
    assert np.all(r < 1.05)


def test_nuts_windowed_mass_matrix_adaptation():
    """Stan-style windowed adaptation learns a badly-scaled target's
    variances from the identity start: the adapted diagonal M⁻¹ must match
    the true marginal variances and moments must recover — the
    standalone-sampler completeness path (no Pathfinder metric needed)."""
    scales = jnp.asarray([0.05, 1.0, 20.0, 5.0])  # sd spread 400:1
    d = scales.shape[0]
    vg = jax.value_and_grad(lambda x: -0.5 * jnp.sum((x / scales) ** 2))
    out = nuts(
        jax.random.key(5), vg, None, jnp.zeros(d),
        num_samples=4000, num_warmup=800, adapt_mass_matrix=True,
    )
    assert out.inv_mass_diag is not None
    np.testing.assert_allclose(
        np.asarray(out.inv_mass_diag), np.asarray(scales) ** 2, rtol=0.5
    )
    xs = np.asarray(out.samples)
    np.testing.assert_allclose(
        xs.std(axis=0), np.asarray(scales), rtol=0.15
    )
    assert np.abs(xs.mean(axis=0) / np.asarray(scales)).max() < 0.15
    # without adaptation the identity metric needs deep trees on this target;
    # with it the average depth must drop
    out_fixed = nuts(
        jax.random.key(5), vg, None, jnp.zeros(d),
        num_samples=1000, num_warmup=800,
    )
    assert float(np.asarray(out.tree_depths).mean()) < float(
        np.asarray(out_fixed.tree_depths).mean()
    )


def test_nuts_adaptation_keeps_lowrank_structure():
    """Adaptation must also run when the initial metric is a low-rank
    Pathfinder fit (the metric pytree carries zero-masked B/D columns)."""
    d = 5
    target = CorrelatedGaussian(d, seed=4)
    res = pathfinder(
        target, key=jax.random.key(0), ndraws=10, maxiters=80, history_length=d
    )
    out = nuts(
        jax.random.key(6), target.value_and_grad,
        WoodburyMetric.from_result(res), res.draws[:, 0],
        num_samples=2000, num_warmup=500, adapt_mass_matrix=True,
    )
    xs = np.asarray(out.samples)
    np.testing.assert_allclose(xs.mean(axis=0), target.mean, atol=0.2)
    np.testing.assert_allclose(
        np.asarray(out.inv_mass_diag), np.diag(target.cov), rtol=0.6
    )


def test_nuts_funnel_mixes_into_neck():
    """The funnel is hard for unit-metric NUTS, but the chain must at least
    explore negative v without diverging wholesale."""
    target = NealsFunnel(11)
    out = nuts(
        jax.random.key(3), target.value_and_grad, identity_metric(11),
        jnp.zeros(11), num_samples=4000, num_warmup=600,
    )
    v = np.asarray(out.samples)[:, 0]
    assert v.min() < -2.0 and v.max() > 2.0
    assert np.asarray(out.diverging).mean() < 0.2


def test_warmup_schedule_validation():
    """Degenerate window parameters raise instead of hanging the host in
    an infinite schedule loop (code-review regression)."""
    vg = jax.value_and_grad(lambda x: -0.5 * jnp.sum(x * x))
    with pytest.raises(ValueError, match="base_window"):
        nuts(jax.random.key(0), vg, None, jnp.zeros(2),
             num_samples=10, num_warmup=500, adapt_mass_matrix=True,
             base_window=0)
    with pytest.raises(ValueError, match="base_window"):
        nuts(jax.random.key(0), vg, None, jnp.zeros(2),
             num_samples=10, num_warmup=500, adapt_mass_matrix=True,
             init_buffer=-1)


def test_nuts_chains_with_summary():
    """nuts_chains stacks C chains and returns the diagnostics summary;
    warm-started chains on a well-conditioned target mix (rhat ~ 1,
    healthy bulk and tail ESS)."""
    d = 4
    target = CorrelatedGaussian(d, seed=9)
    res = pathfinder(target, key=jax.random.key(0), ndraws=8, maxiters=60,
                     history_length=d)
    from pathfinder_tpu.integrations.nuts import nuts_chains

    out, summary = nuts_chains(
        jax.random.key(1), target.value_and_grad,
        WoodburyMetric.from_result(res), res.draws[:, :4].T,
        num_samples=1000, num_warmup=300,
    )
    assert out.samples.shape == (4, 1000, d)
    assert summary["rhat"].shape == (d,)
    assert np.all(np.asarray(summary["rhat"]) < 1.05)
    assert np.all(np.asarray(summary["ess_bulk"]) > 300)
    assert np.all(np.asarray(summary["ess_tail"]) > 200)
    np.testing.assert_allclose(
        np.asarray(summary["mean"]), target.mean, atol=0.2
    )
    # a second identical call hits the persistent pjit cache instead of
    # re-tracing a per-call lambda (which would recompile the sampler)
    from pathfinder_tpu.integrations.nuts import _nuts_vmapped

    n_before = _nuts_vmapped._cache_size()
    out2, _ = nuts_chains(
        jax.random.key(1), target.value_and_grad,
        WoodburyMetric.from_result(res), res.draws[:, :4].T,
        num_samples=1000, num_warmup=300,
    )
    assert _nuts_vmapped._cache_size() == n_before
    np.testing.assert_array_equal(
        np.asarray(out2.samples), np.asarray(out.samples)
    )


def test_nuts_nonfinite_start_is_visible_not_stuck():
    """A chain started outside the support (logp = -inf) must NOT return
    num_samples copies of x0 with healthy-looking accept_stat=1; the
    outputs are NaN-poisoned (Stan aborts on non-finite initial energy)
    and nuts_chains raises at the host boundary."""
    from pathfinder_tpu.integrations.nuts import nuts, nuts_chains

    def logp(x):
        return jnp.where(
            jnp.all(x > 0), -0.5 * jnp.sum(x * x), -jnp.inf
        )

    vg = jax.value_and_grad(logp)
    out = nuts(
        jax.random.key(0), vg, None, jnp.full(3, -1.0),
        num_samples=20, num_warmup=10,
    )
    assert np.isnan(np.asarray(out.samples)).all()
    assert np.all(np.asarray(out.accept_stat) == 0.0)
    assert np.all(np.asarray(out.diverging))
    # in-support start still works
    ok = nuts(
        jax.random.key(0), vg, None, jnp.full(3, 1.0),
        num_samples=20, num_warmup=10,
    )
    assert np.isfinite(np.asarray(ok.samples)).all()
    import pytest

    with pytest.raises(ValueError, match="chains \\[1\\] start at"):
        nuts_chains(
            jax.random.key(1), vg, None,
            jnp.stack([jnp.full(3, 1.0), jnp.full(3, -1.0)]),
            num_samples=10, num_warmup=5,
        )


def test_diag_metric_closed_form_matches_factorized():
    """WoodburyMetric.diag's closed-form factor is equivalent to the
    general pdfactorize path (which it replaced in the warmup scan)."""
    from pathfinder_tpu.ops.woodbury import WoodburyPDMat

    rng = np.random.default_rng(4)
    var = jnp.asarray(rng.uniform(0.5, 2.0, 6))
    m_closed = WoodburyMetric.diag(var, rank=4)
    w_general = WoodburyPDMat.from_parts(
        var, jnp.zeros((6, 4)), jnp.zeros((4, 4)),
        col_mask=jnp.zeros((4,)),
    )
    np.testing.assert_allclose(
        np.asarray(m_closed.minv.to_dense()),
        np.asarray(w_general.to_dense()),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(m_closed.minv.logdet()), float(w_general.logdet()), rtol=1e-6
    )
    p = jnp.asarray(rng.standard_normal(6))
    np.testing.assert_allclose(
        float(m_closed.kinetic_energy(p)),
        0.5 * float(p @ w_general.to_dense() @ p),
        rtol=1e-5,
    )
    # same pytree structure (required for the in-scan metric swap)
    t1 = jax.tree_util.tree_structure(m_closed.minv)
    t2 = jax.tree_util.tree_structure(w_general)
    assert t1 == t2


# ---------------------------------------------------------------------------
# Truth-anchored referee validation: the in-repo NUTS
# vs machine-precision ground truth, breaking the end-to-end circularity
# (previously NUTS was only checked on Gaussian/banana shapes and the
# end-to-end test used NUTS warm-started by the fit under test). Methodology
# = the reference's z-test + MCSE + Bonferroni approach
# (test/integration/DynamicHMC/runtests.jl:75-142).
# ---------------------------------------------------------------------------


def test_nuts_truth_anchored_hierarchical():
    """Standalone NUTS (identity start, windowed adaptation on) on the
    quadrature-truth hierarchical target: per-coordinate z-test of the
    posterior mean against exact truth with MCSE-based Bonferroni
    tolerances, plus sd agreement."""
    from pathfinder_tpu.models.zoo import (
        HierarchicalGaussian,
        hierarchical_gaussian_truth,
    )

    d = 16
    target = HierarchicalGaussian(d, seed=0)
    mean_true, sd_true = hierarchical_gaussian_truth(d, seed=0)

    out = nuts(
        jax.random.key(3), target.value_and_grad, None,
        jnp.zeros(d), num_samples=4000, num_warmup=800,
        adapt_mass_matrix=True,
    )
    xs = np.asarray(out.samples)  # (N, d)
    assert np.asarray(out.diverging).mean() < 0.02
    ess = np.asarray(ess_bulk(xs[None]))
    assert np.all(ess > 100), ess.min()

    # z-test per coordinate: |mean_hat - mean_true| < z * MCSE,
    # MCSE = sd_true / sqrt(ESS); Bonferroni at level 0.01 over d tests
    from scipy import stats as st

    z = st.norm.ppf(1 - 0.01 / (2 * d))  # ≈ 3.4 at d=16
    mcse = sd_true / np.sqrt(ess)
    zerr = np.abs(xs.mean(axis=0) - mean_true) / mcse
    assert np.all(zerr < z), (zerr.max(), z)

    # sd agreement: MCSE(sd) ≈ sd/sqrt(2 ESS) for near-Gaussian marginals
    sd_hat = xs.std(axis=0)
    sd_tol = z * sd_true / np.sqrt(2 * ess) + 0.02 * sd_true
    assert np.all(np.abs(sd_hat - sd_true) < sd_tol)


def test_nuts_truth_anchored_conjugate():
    """NUTS vs an exactly-known correlated Gaussian posterior (Bayesian
    linear regression with known noise — conjugate, Σ* = (XᵀX+I)⁻¹,
    μ* = Σ*Xᵀy): mean z-test + sd and cross-correlation agreement."""
    rng = np.random.default_rng(11)
    n, d = 60, 8
    X = rng.standard_normal((n, d))
    beta_true = rng.standard_normal(d)
    y = X @ beta_true + rng.standard_normal(n)
    prec = X.T @ X + np.eye(d)
    cov_true = np.linalg.inv(prec)
    mu_true = cov_true @ (X.T @ y)
    sd_true = np.sqrt(np.diag(cov_true))

    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    def logp(b):
        r = yj - Xj @ b
        return -0.5 * jnp.sum(r * r) - 0.5 * jnp.sum(b * b)

    out = nuts(
        jax.random.key(4), jax.value_and_grad(logp), None,
        jnp.zeros(d), num_samples=4000, num_warmup=800,
        adapt_mass_matrix=True,
    )
    xs = np.asarray(out.samples)
    assert not np.any(np.asarray(out.diverging))
    ess = np.asarray(ess_bulk(xs[None]))
    assert np.all(ess > 200)

    from scipy import stats as st

    z = st.norm.ppf(1 - 0.01 / (2 * d))
    zerr = np.abs(xs.mean(axis=0) - mu_true) / (sd_true / np.sqrt(ess))
    assert np.all(zerr < z), (zerr.max(), z)
    np.testing.assert_allclose(xs.std(axis=0), sd_true, rtol=0.1)
    # correlation structure (not just marginals)
    corr_hat = np.corrcoef(xs.T)
    corr_true = cov_true / np.outer(sd_true, sd_true)
    assert np.max(np.abs(corr_hat - corr_true)) < 0.1


def test_nuts_chains_sharded_matches_unsharded():
    """``nuts_chains(mesh=...)`` shards the chains axis over devices;
    per-chain keys are split before placement, so the discrete sampler
    decisions (tree depths, divergences) replay identically and the
    trajectories agree to floating-point-reassociation level (per-device
    batch width changes XLA's vectorization grouping — see docstring)."""
    from pathfinder_tpu.integrations.nuts import nuts_chains
    from pathfinder_tpu.parallel.sharding import paths_mesh

    d = 4
    target_vg = jax.value_and_grad(lambda x: -0.5 * jnp.sum(x * x))
    x0s = jnp.asarray(np.random.default_rng(0).standard_normal((8, d)))
    kw = dict(num_samples=60, num_warmup=40, max_depth=5)

    out_u, sum_u = nuts_chains(
        jax.random.key(0), target_vg, identity_metric(d), x0s, **kw
    )
    mesh = paths_mesh()
    out_s, sum_s = nuts_chains(
        jax.random.key(0), target_vg, identity_metric(d), x0s, mesh=mesh, **kw
    )
    np.testing.assert_allclose(
        np.asarray(out_s.samples), np.asarray(out_u.samples), atol=1e-9
    )
    np.testing.assert_array_equal(
        np.asarray(out_s.tree_depths), np.asarray(out_u.tree_depths)
    )
    np.testing.assert_array_equal(
        np.asarray(out_s.diverging), np.asarray(out_u.diverging)
    )
    # rank-normalized diagnostics are discrete in the samples: a last-ulp
    # perturbation can flip a rank, so compare loosely
    np.testing.assert_allclose(
        np.asarray(sum_s["rhat"]), np.asarray(sum_u["rhat"]), atol=0.01
    )
    # indivisible chain counts are rejected, not silently replicated
    with pytest.raises(ValueError, match="divisible"):
        nuts_chains(
            jax.random.key(0), target_vg, identity_metric(d), x0s[:5],
            mesh=mesh, **kw
        )
    # 2-D mesh: the chain axis shards over the FIRST axis only, so the
    # divisibility check uses that axis's width (4), not the total (8)
    from jax.sharding import Mesh

    mesh2d = Mesh(
        np.asarray(jax.devices()[:8]).reshape(4, 2), ("c", "other")
    )
    out_2d, _ = nuts_chains(
        jax.random.key(0), target_vg, identity_metric(d), x0s[:4],
        mesh=mesh2d, num_samples=20, num_warmup=10, max_depth=4,
    )
    assert np.isfinite(np.asarray(out_2d.samples)).all()
