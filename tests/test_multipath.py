"""Multi-path Pathfinder tests (porting ``test/multipath.jl``).

Covers: result shape/metadata invariants (``:30-48``), moment recovery on a
correlated Gaussian (``:49-61``), determinism — including across mesh shapes,
the shard_map analog of the reference's ntasks-independence contract
(``:107-140``) — and the ``resample`` behavior matrix (``:142-232``).
"""

import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pathfinder_tpu.models import CorrelatedGaussian, StandardNormal
from pathfinder_tpu.multipath import multipathfinder, resample
from pathfinder_tpu.parallel.sharding import paths_mesh


def run_multi(key=0, nruns=6, ndraws=200, d=5, **kw):
    target = CorrelatedGaussian(d, seed=2)
    kw.setdefault("maxiters", 60)
    kw.setdefault("history_length", d)
    res = multipathfinder(
        target, ndraws, key=jax.random.key(key), nruns=nruns, **kw
    )
    return res, target


def test_shapes_and_metadata():
    res, target = run_multi(ndraws=120, nruns=4)
    d = 5
    assert res.draws.shape == (d, 120)
    assert res.draw_component_ids.shape == (120,)
    assert set(np.unique(np.asarray(res.draw_component_ids))) <= set(range(4))
    assert res.fit_distribution.ncomponents == 4
    assert res.psis_result is not None
    np.testing.assert_allclose(np.asarray(res.psis_result.weights).sum(), 1.0, rtol=1e-6)
    assert res.nruns == 4
    assert np.all(np.asarray(res.states.success))
    assert "Pareto shape diagnostic" in repr(res)
    # per-path result views
    pr = res.path_result(0)
    assert pr.success
    assert pr.draws.shape[0] == d


def test_moment_recovery():
    """Pooled PSIS draws recover mean/cov of a correlated Gaussian (reference
    ``test/multipath.jl:49-61`` with inflated asymptotic tolerances)."""
    d = 5
    res, target = run_multi(key=1, nruns=8, ndraws=4000, d=d, ndraws_per_run=600)
    x = np.asarray(res.draws)
    # resampling with replacement deflates ESS; allow wide tolerances
    np.testing.assert_allclose(x.mean(axis=1), target.mean, atol=0.25)
    np.testing.assert_allclose(np.cov(x), target.cov, atol=0.5, rtol=0.5)
    k = float(res.psis_result.pareto_shape)
    assert k < 0.7, f"pareto shape {k} should be good/ok on a Gaussian target"


def test_moment_recovery_reference_shape():
    """The reference's exact configuration: 10-D correlated Gaussian, 20
    runs, large draw pool, moments within 15× asymptotic SE
    (``test/multipath.jl:49-61``)."""
    d = 10
    target = CorrelatedGaussian(d, seed=7)
    ndraws = 100_000
    res = multipathfinder(
        target, ndraws, key=jax.random.key(77), nruns=20, maxiters=80,
        history_length=d, ndraws_per_run=6000,
    )
    assert np.all(np.asarray(res.states.success))
    x = np.asarray(res.draws)
    se_mean = np.sqrt(np.diag(target.cov) / ndraws)
    assert np.all(np.abs(x.mean(axis=1) - target.mean) < 15 * se_mean)
    var_true = np.diag(target.cov)
    se_var = var_true * np.sqrt(2.0 / (ndraws - 1))
    assert np.all(np.abs(x.var(axis=1) - var_true) < 15 * se_var)


def test_reproducibility_and_key_sensitivity():
    r1, _ = run_multi(key=3)
    r2, _ = run_multi(key=3)
    r3, _ = run_multi(key=4)
    np.testing.assert_array_equal(np.asarray(r1.draws), np.asarray(r2.draws))
    np.testing.assert_array_equal(
        np.asarray(r1.draw_component_ids), np.asarray(r2.draw_component_ids)
    )
    assert not np.array_equal(np.asarray(r1.draws), np.asarray(r3.draws))


def test_determinism_across_mesh_shapes():
    """Mesh-shape independence — the shard_map analog of the reference's
    ntasks-independence tests (``test/multipath.jl:107-140``). The
    contract has two tiers: every DISCRETE output (component ids) is
    exactly equal, and the float draws agree to floating-point
    reassociation tolerance (per-device batch width can change XLA's
    reduction grouping in the sample stage — measured <= 3e-14; the
    trajectories themselves are bitwise equal, asserted by the cg
    variant below on the traces)."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    mesh2 = paths_mesh(jax.devices()[:2])
    mesh4 = paths_mesh(jax.devices()[:4])
    r_none, _ = run_multi(key=5, nruns=8)
    r_m2, _ = run_multi(key=5, nruns=8, mesh=mesh2)
    r_m4, _ = run_multi(key=5, nruns=8, mesh=mesh4)
    for r in (r_m2, r_m4):
        np.testing.assert_array_equal(
            np.asarray(r_none.draw_component_ids),
            np.asarray(r.draw_component_ids),
        )
        np.testing.assert_array_equal(
            np.asarray(r_none.states.fit_iteration),
            np.asarray(r.states.fit_iteration),
        )
        np.testing.assert_allclose(
            np.asarray(r_none.draws), np.asarray(r.draws), rtol=0, atol=1e-12
        )


def test_determinism_across_mesh_shapes_cg_optimizer():
    """The CG optimizer's extra carried state (previous direction / slope)
    must not break the across-mesh-shapes determinism contract.

    The trajectory (every iterate, valid count, eval count) and the ELBO
    winner are bit-identical across mesh shapes — JAX's batched
    ``while_loop`` select-masks the whole carry for finished lanes, so
    no per-lane gating is needed in the loop body. The *draws* are only
    identical up to the documented last-ulp matmul-tiling caveat
    (different per-device batch widths can tile the sample-stage matmuls
    differently; measured ~7e-9 here), which the CG trajectories happen
    to expose while the L-BFGS shapes tile identically."""
    mesh4 = paths_mesh(jax.devices()[:4])
    r_none, _ = run_multi(key=7, nruns=8, optimizer="cg")
    r_m4, _ = run_multi(key=7, nruns=8, mesh=mesh4, optimizer="cg")
    assert np.all(np.asarray(r_none.states.success))
    # algorithmic decisions: bitwise identical
    np.testing.assert_array_equal(
        np.asarray(r_none.states.trace.xs), np.asarray(r_m4.states.trace.xs)
    )
    np.testing.assert_array_equal(
        np.asarray(r_none.states.trace.num_valid),
        np.asarray(r_m4.states.trace.num_valid),
    )
    np.testing.assert_array_equal(
        np.asarray(r_none.states.num_fn_evals),
        np.asarray(r_m4.states.num_fn_evals),
    )
    np.testing.assert_array_equal(
        np.asarray(r_none.states.fit_iteration),
        np.asarray(r_m4.states.fit_iteration),
    )
    # draws: last-ulp tiling differences allowed (f32 scale)
    np.testing.assert_allclose(
        np.asarray(r_none.draws), np.asarray(r_m4.draws), rtol=0, atol=1e-5
    )


def test_mesh_padding_non_divisible():
    mesh4 = paths_mesh(jax.devices()[:4])
    res, _ = run_multi(key=6, nruns=6, mesh=mesh4)  # 6 paths on 4 devices
    assert res.nruns == 6
    assert np.all(np.asarray(res.states.success))


def test_pad_paths_alignment_rule():
    """Large K pads to a multiple of 256 (nearby path counts share one
    batch width); small K is never padded; mesh divisibility composes;
    align=False opts out."""
    from pathfinder_tpu.parallel.sharding import pad_paths

    mesh4 = paths_mesh(jax.devices()[:4])
    assert pad_paths(100, None) == 100
    assert pad_paths(2047, None) == 2047  # below the threshold: unchanged
    assert pad_paths(2048, None) == 2048
    assert pad_paths(3000, None) == 3072
    assert pad_paths(4000, mesh4) == 4096
    assert pad_paths(3000, None, align=False) == 3000
    assert pad_paths(6, mesh4) == 8  # mesh rule unchanged at small K


def _nan_wall_logp(x):
    """N(0, I) inside |x|_inf < 3, NaN outside — the forced-retry target
    shared by the retry tests (init_scale 8 => ~14% in-support per try)."""
    clean = -0.5 * jnp.sum(x * x)
    return jnp.where(jnp.max(jnp.abs(x)) > 3.0, jnp.nan, clean)


_RETRY_KW = dict(
    dim=2, key=jax.random.key(12), nruns=6, init_scale=8.0,
    ntries=400, maxiters=30,
)


@pytest.fixture(scope="module")
def retry_result_unsharded():
    # one retry-heavy run shared by both retry tests (the run itself is
    # the expensive part: ~tens of retry rounds x compile-cached shapes)
    return multipathfinder(_nan_wall_logp, 100, **_RETRY_KW)


def test_multipath_retry_rounds(retry_result_unsharded):
    """Failed lanes are retried in compacted batches until success."""
    res = retry_result_unsharded
    nt = np.asarray(res.num_tries)
    assert np.all(np.asarray(res.states.success))
    assert nt.max() > 1  # at least one lane needed a retry round
    assert np.all(np.isfinite(np.asarray(res.draws)))


def test_retry_rounds_ride_the_mesh_deterministically(retry_result_unsharded):
    """Retry rounds reuse the sharded executor; a sharded run with forced
    failures matches the unsharded run (same two-tier contract as
    test_determinism_across_mesh_shapes: discrete outputs exact, draws to
    reassociation tolerance), extending mesh determinism to the retry
    path."""
    r_none = retry_result_unsharded
    mesh4 = paths_mesh(jax.devices()[:4])
    r_mesh = multipathfinder(_nan_wall_logp, 100, mesh=mesh4, **_RETRY_KW)
    assert np.asarray(r_none.num_tries).max() > 1  # retries actually fired
    np.testing.assert_array_equal(
        np.asarray(r_none.num_tries), np.asarray(r_mesh.num_tries)
    )
    np.testing.assert_array_equal(
        np.asarray(r_none.draw_component_ids),
        np.asarray(r_mesh.draw_component_ids),
    )
    np.testing.assert_allclose(
        np.asarray(r_none.draws), np.asarray(r_mesh.draws), rtol=0, atol=1e-12
    )


def test_optimizer_auto_custom_set_and_perfect_fit_rank():
    """auto_optimizers widens the competition; a NaN-k̂ PERFECT fit
    (newton on an exact Gaussian: uniform weights, ESS = N) must rank
    best, not be discarded as 'not computed'."""
    target = StandardNormal(4)
    res = multipathfinder(
        target, 60, key=jax.random.key(15), nruns=4, maxiters=40,
        optimizer="auto", auto_optimizers=("lbfgs", "newton"),
        auto_khat_early_exit=None,  # exhaustive competition
    )
    # newton's exact fit wins via the uniform-weight ESS rule
    assert res.config.optimizer == "newton"
    ess_frac = float(res.psis_result.ess) / res.psis_result.weights.shape[0]
    assert ess_frac >= 0.99
    # input validation: typos / wrong spellings fail fast, BEFORE any
    # full sub-run burns compute
    with pytest.raises(ValueError, match="unknown auto_optimizers"):
        multipathfinder(
            target, 10, key=jax.random.key(0), nruns=2, maxiters=10,
            optimizer="auto", auto_optimizers=("lbfgs", "newtn"),
        )
    with pytest.raises(ValueError, match="at least one"):
        multipathfinder(
            target, 10, key=jax.random.key(0), nruns=2, maxiters=10,
            optimizer="auto", auto_optimizers=(),
        )
    with pytest.raises(ValueError, match="requires optimizer='auto'"):
        multipathfinder(
            target, 10, key=jax.random.key(0), nruns=2, maxiters=10,
            auto_optimizers=("lbfgs",),
        )
    # a bare string names one optimizer (not iterated per character)
    r1 = multipathfinder(
        target, 20, key=jax.random.key(1), nruns=2, maxiters=20,
        optimizer="auto", auto_optimizers="lbfgs",
    )
    assert r1.config.optimizer == "lbfgs"


def test_optimizer_auto_selects_by_khat():
    """optimizer="auto" runs both optimizers and returns the lower-k̂
    result (k̂ as fit diagnostic, Yao et al. 2018 — beyond-reference)."""
    r_auto, _ = run_multi(
        key=11, nruns=6, optimizer="auto", auto_khat_early_exit=None
    )
    r_l, _ = run_multi(key=11, nruns=6, optimizer="lbfgs")
    r_c, _ = run_multi(key=11, nruns=6, optimizer="cg")
    k_auto = float(r_auto.psis_result.pareto_shape)
    k_l = float(r_l.psis_result.pareto_shape)
    k_c = float(r_c.psis_result.pareto_shape)
    assert r_auto.config.optimizer in ("lbfgs", "cg")
    assert k_auto == min(k_l, k_c)
    # the returned result IS the winner's full result
    winner = r_l if k_l <= k_c else r_c
    np.testing.assert_array_equal(
        np.asarray(r_auto.draws), np.asarray(winner.draws)
    )


def test_optimizer_auto_early_exit():
    """A first candidate at k̂ < auto_khat_early_exit (default 0.7, the
    "ok" verdict boundary) ends the competition without running later
    candidates (auto ≈ one run on easy targets);
    auto_khat_early_exit=None restores the exhaustive competition."""
    from pathfinder_tpu.ops.lbfgs import minimize_lbfgs_trace

    target = StandardNormal(4)
    calls = []

    def spy_optimizer(value_and_grad, x0, **kw):
        calls.append(1)
        return minimize_lbfgs_trace(value_and_grad, x0, **kw)

    kw = dict(
        key=jax.random.key(21), nruns=4, maxiters=40,
        optimizer="auto", auto_optimizers=("lbfgs", spy_optimizer),
    )
    res = multipathfinder(target, 60, **kw)
    # lbfgs on a standard normal fits well under the 0.7 boundary, so the
    # spy candidate must never have been traced
    assert float(res.psis_result.pareto_shape) < 0.7 or (
        float(res.psis_result.ess)
        / res.psis_result.weights.shape[0] >= 0.99
    )
    assert res.config.optimizer == "lbfgs"
    assert not calls
    # threshold None → the spy candidate runs
    multipathfinder(target, 60, auto_khat_early_exit=None, **kw)
    assert calls
    # validation: the kwarg is auto-mode-only
    with pytest.raises(ValueError, match="requires optimizer='auto'"):
        multipathfinder(
            target, 10, key=jax.random.key(0), nruns=2, maxiters=10,
            auto_khat_early_exit=0.5,
        )
    # a non-numeric threshold fails fast at the call boundary — before any
    # candidate pipeline runs (a late failure would waste the whole run)
    with pytest.raises((TypeError, ValueError)):
        multipathfinder(target, 10, auto_khat_early_exit="bogus", **kw)
    assert len(calls) == 1  # the spy never ran again


def test_optimizer_auto_requires_importance():
    with pytest.raises(ValueError, match="importance=True"):
        run_multi(key=11, nruns=4, optimizer="auto", importance=False)


def test_optimizer_auto_result_resamples():
    """The auto-selected result is a full MultiPathfinderResult — post-hoc
    resample works and the winner's config travels with it."""
    r_auto, _ = run_multi(key=12, nruns=4, optimizer="auto")
    r2 = resample(r_auto, 50)
    assert r2.draws.shape == (5, 50)
    assert r2.config.optimizer == r_auto.config.optimizer
    assert np.all(np.isfinite(np.asarray(r2.draws)))


def test_more_draws_than_pool_warns():
    with pytest.warns(UserWarning, match="More draws requested"):
        run_multi(ndraws=100, nruns=2, ndraws_per_run=10)


def test_importance_false():
    res, _ = run_multi(key=7, importance=False)
    assert res.psis_result is None


def test_explicit_init_matrix():
    target = StandardNormal(3)
    init = jnp.asarray(np.random.default_rng(0).uniform(-2, 2, (5, 3)))
    res = multipathfinder(
        target, 50, key=jax.random.key(8), init=init, maxiters=40
    )
    assert res.nruns == 5
    assert res.draws.shape == (3, 50)


def test_input_validation_conflicts():
    """Conflicting inputs error loudly instead of silently picking one:
    nruns vs init rows, init width vs target dim, bad elbo_chunk; and
    sub-32-bit dtype warns (the measured 0/100-success diagnosis) in
    multipath like it does in singlepath."""
    target = StandardNormal(3)
    with pytest.raises(ValueError, match="conflicts with init"):
        multipathfinder(
            target, 10, key=jax.random.key(0), nruns=4,
            init=jnp.zeros((5, 3)), maxiters=10,
        )
    with pytest.raises(ValueError, match="target's dimension is 3"):
        multipathfinder(
            target, 10, key=jax.random.key(0), init=jnp.zeros((2, 4)),
            maxiters=10,
        )
    with pytest.raises(ValueError, match="elbo_chunk"):
        multipathfinder(
            target, 10, key=jax.random.key(0), nruns=2, maxiters=10,
            elbo_chunk=0,
        )
    with pytest.warns(UserWarning, match="numerically unusable"):
        try:
            multipathfinder(
                target, 4, key=jax.random.key(0), nruns=2, maxiters=3,
                ntries=1, dtype=jnp.bfloat16,
            )
        except Exception:
            pass  # bf16 runs may fail; the warning is the contract


def test_chained_resample_gets_fresh_randomness():
    """resample(resample(r)) with default keys must not replay identical
    draws — the stored key advances per call (the reference's RNG state
    advances)."""
    res, _ = run_multi(key=21, nruns=4, ndraws=200, ndraws_per_run=100)
    r2 = resample(res, 100)
    r3 = resample(r2, 100)
    assert not np.array_equal(np.asarray(r2.draws), np.asarray(r3.draws))
    # still deterministic end-to-end: the chain replays exactly
    r2b = resample(res, 100)
    r3b = resample(r2b, 100)
    np.testing.assert_array_equal(np.asarray(r3.draws), np.asarray(r3b.draws))


class TestResample:
    """Behavior matrix of post-hoc ``resample`` (reference
    ``test/multipath.jl:142-232``)."""

    @pytest.fixture(scope="class")
    def result(self):
        res, target = run_multi(key=9, nruns=4, ndraws=100, ndraws_per_run=50)
        return res

    def test_with_replacement_reuses_stored(self, result):
        r2 = resample(result, 80)
        assert r2.draws.shape == (5, 80)
        # stored draws + stored PSIS reused: every draw is from the pool
        pool = np.asarray(result.draws_per_component).reshape(-1, 5)
        for col in np.asarray(r2.draws).T:
            assert np.isclose(pool, col[None, :]).all(axis=1).any()
        # original result not mutated
        assert result.draws.shape == (5, 100)
        assert r2.psis_result is result.psis_result

    def test_without_replacement_unique(self, result):
        r2 = resample(result, 60, replace=False)
        cols = np.asarray(r2.draws).T
        assert len(np.unique(cols.round(12), axis=0)) == 60

    def test_without_importance(self, result):
        r2 = resample(result, 50, importance=False)
        assert r2.psis_result is None
        assert r2.draws.shape == (5, 50)

    def test_fresh_draws_per_run(self, result):
        r2 = resample(result, 120, ndraws_per_run=100)
        assert r2.draws.shape == (5, 120)
        # fresh draws are NOT from the stored pool
        pool = np.asarray(result.draws_per_component).reshape(-1, 5)
        cols = np.asarray(r2.draws).T
        overlap = sum(
            bool(np.isclose(pool, c[None, :]).all(axis=1).any()) for c in cols
        )
        assert overlap == 0
        # PSIS recomputed on the fresh pool
        assert r2.psis_result is not result.psis_result

    def test_field_preservation(self, result):
        r2 = resample(result, 30)
        assert r2.fit_distribution is result.fit_distribution
        assert r2.states is result.states
        assert r2.logp is result.logp
        np.testing.assert_array_equal(
            np.asarray(r2.num_tries), np.asarray(result.num_tries)
        )

    def test_deterministic_given_key(self, result):
        a = resample(result, 40, key=jax.random.key(1))
        b = resample(result, 40, key=jax.random.key(1))
        np.testing.assert_array_equal(np.asarray(a.draws), np.asarray(b.draws))

    def test_recomputes_psis_when_absent(self):
        """resample(importance=True) on a result stored WITHOUT PSIS
        (importance=False run) computes it from the stored draws — the
        reference's no-stored-PSIS path (``src/resample.jl:32-38``,
        ``test/resample.jl:143-149``)."""
        res, _ = run_multi(key=13, nruns=4, importance=False)
        assert res.psis_result is None
        r2 = resample(res, 50)
        assert r2.psis_result is not None
        np.testing.assert_allclose(
            float(np.asarray(r2.psis_result.weights).sum()), 1.0, rtol=1e-5
        )
        assert r2.draws.shape == (5, 50)


def test_mixture_denominator_single_component_equals_component():
    """With K=1 the mixture is its only component, so both denominators
    must give identical PSIS weights."""
    from pathfinder_tpu.multipath import _compute_psis_result

    target = StandardNormal(4)
    res = multipathfinder(target, 50, key=jax.random.key(0), nruns=1,
                          maxiters=40)
    comps = res.fit_distribution.components
    a = _compute_psis_result(target.logp, comps, res.draws_per_component,
                             denominator="component")
    b = _compute_psis_result(target.logp, comps, res.draws_per_component,
                             denominator="mixture")
    np.testing.assert_allclose(
        np.asarray(a.weights), np.asarray(b.weights), rtol=1e-5
    )


def test_mixture_denominator_improves_overlapping_fits():
    """When components overlap, the pooled draws are mixture-distributed,
    so mixture-denominator ratios have lower variance — measured as
    higher importance-weight ESS (and no worse khat). Measured on the
    32-path logreg d=25: khat 0.30 -> 0.02, ESS 468 -> 727."""
    target = CorrelatedGaussian(12, seed=2)
    kw = dict(key=jax.random.key(3), nruns=8, maxiters=80)
    r_comp = multipathfinder(target, 400, importance_denominator="component", **kw)
    r_mix = multipathfinder(target, 400, importance_denominator="mixture", **kw)

    def ess(r):
        w = np.asarray(r.psis_result.weights, np.float64)
        return 1.0 / np.sum(w**2)

    assert ess(r_mix) >= ess(r_comp)
    assert float(r_mix.psis_result.pareto_shape) <= float(
        r_comp.psis_result.pareto_shape
    ) + 0.05


def test_resample_importance_denominator_override():
    """resample(importance_denominator=...) forces a PSIS recompute with
    the requested ratios even when a stored result exists."""
    target = CorrelatedGaussian(8, seed=5)
    res = multipathfinder(target, 100, key=jax.random.key(1), nruns=4,
                          maxiters=60)
    r2 = resample(res, 100, key=jax.random.key(2),
                  importance_denominator="mixture")
    assert r2.psis_result is not None
    # stored (component) weights differ from the recomputed mixture ones
    assert not np.allclose(
        np.asarray(res.psis_result.weights), np.asarray(r2.psis_result.weights)
    )
    # unknown denominator raises
    with pytest.raises(ValueError, match="importance_denominator"):
        resample(res, 50, key=jax.random.key(3),
                 importance_denominator="geometric")


def test_mixture_denominator_under_mesh():
    """The K²·N mixture logpdfs compile under a paths mesh (GSPMD inserts
    the component all-gather); resampled draws match the unsharded run and
    weights agree to reduction-order tolerance (the logsumexp across
    sharded components is the one op without a fixed float order)."""
    target = CorrelatedGaussian(10, seed=3)
    kw = dict(key=jax.random.key(0), nruns=16, maxiters=60,
              importance_denominator="mixture")
    r_mesh = multipathfinder(target, 200, mesh=paths_mesh(), **kw)
    r_none = multipathfinder(target, 200, mesh=None, **kw)
    # the dense-precision target's per-path dot products tile differently
    # at different batch widths, so x64 trajectories agree to ~1e-10, not
    # bit-exactly; the resampling choices themselves must match
    np.testing.assert_array_equal(
        np.asarray(r_mesh.draw_component_ids),
        np.asarray(r_none.draw_component_ids),
    )
    np.testing.assert_allclose(
        np.asarray(r_mesh.draws), np.asarray(r_none.draws), rtol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(r_mesh.psis_result.weights),
        np.asarray(r_none.psis_result.weights),
        rtol=1e-5,
    )


def test_resample_reuses_stored_psis_for_matching_denominator():
    """An explicit denominator equal to the one that produced the stored
    PSIS result reuses it (no recompute); the produced result carries the
    effective denominator so chained resamples stay consistent."""
    target = CorrelatedGaussian(6, seed=7)
    res = multipathfinder(target, 100, key=jax.random.key(1), nruns=4,
                          maxiters=60, importance_denominator="mixture")
    assert res.importance_denominator == "mixture"

    calls = {"n": 0}
    logp0 = res.logp

    def counting_logp(x):
        calls["n"] += 1
        return logp0(x)

    import dataclasses as dc
    res_counting = dc.replace(res, logp=counting_logp)
    r2 = resample(res_counting, 50, key=jax.random.key(2),
                  importance_denominator="mixture")
    assert calls["n"] == 0  # stored mixture PSIS reused, logp never called
    assert r2.importance_denominator == "mixture"
    # chained resample with no explicit denominator keeps using the tag
    r3 = resample(r2, 50, key=jax.random.key(3))
    assert r3.importance_denominator == "mixture"
    # switching denominators does recompute
    r4 = resample(res, 50, key=jax.random.key(4),
                  importance_denominator="component")
    assert r4.importance_denominator == "component"
    assert not np.allclose(
        np.asarray(r4.psis_result.weights), np.asarray(res.psis_result.weights)
    )


def test_resample_fresh_pool_updates_draws_per_component():
    """``resample(ndraws_per_run=N)`` must store the fresh candidate pool it
    computed PSIS on — a chained ``resample`` would otherwise pair the new
    weights with the stale pool (length-mismatched, silently biased)."""
    target = CorrelatedGaussian(4, seed=5)
    res = multipathfinder(
        target, 40, key=jax.random.key(1), nruns=3, maxiters=50
    )
    n0 = res.draws_per_component.shape[1]
    r2 = resample(res, 60, key=jax.random.key(2), ndraws_per_run=n0 + 13)
    assert r2.draws_per_component.shape == (3, n0 + 13, 4)
    assert r2.psis_result.log_weights.size == 3 * (n0 + 13)
    # chained resample on the fresh-pool result: weights and pool agree
    r3 = resample(r2, 60, key=jax.random.key(3))
    assert r3.draws.shape == (4, 60)
    assert np.isfinite(np.asarray(r3.draws)).all()
    # every resampled draw actually comes from the stored pool
    pool = np.asarray(r2.draws_per_component)  # (K, N, d)
    flat = pool.reshape(-1, pool.shape[-1])
    d3 = np.asarray(r3.draws).T  # (60, d)
    for row in d3[:5]:
        assert np.any(np.all(np.isclose(flat, row, atol=1e-6), axis=1))


def test_integer_init_and_dtype_validation():
    """Plain int init lists optimize in float; an explicit integer dtype
    raises a clear error instead of an obscure jnp.finfo ValueError."""
    target = CorrelatedGaussian(3, seed=2)
    res = multipathfinder(
        target, 20, key=jax.random.key(0), nruns=2, maxiters=40,
        init=[[0, 0, 0], [1, 1, 1]],
    )
    assert jnp.issubdtype(res.draws.dtype, jnp.floating)
    assert np.asarray(res.states.success).all()
    with pytest.raises(ValueError, match="floating"):
        multipathfinder(
            target, 20, key=jax.random.key(0), nruns=2, maxiters=40,
            dtype=jnp.int32,
        )


class TestLaplaceResample:
    """Post-hoc Laplace covariance correction (beyond reference; the
    measured remedy at the d=1000 bench target)."""

    @pytest.fixture(scope="class")
    def result(self):
        res, target = run_multi(key=21, nruns=4, ndraws=100, ndraws_per_run=50)
        return res, target

    def test_full_recovers_exact_gaussian_covariance(self, result):
        """On a Gaussian target −H is the precision everywhere, so
        method='full' must install the exact target covariance at every
        component."""
        from pathfinder_tpu.multipath import laplace_resample

        res, target = result
        r2 = laplace_resample(res, 80, method="full")
        for k in range(r2.nruns):
            cov = r2.fit_distribution.component(k).cov.to_dense()
            np.testing.assert_allclose(
                np.asarray(cov), target.cov, rtol=2e-3, atol=2e-4
            )
        # means are preserved — the correction only swaps covariances
        np.testing.assert_array_equal(
            np.asarray(r2.fit_distribution.components.mean),
            np.asarray(res.fit_distribution.components.mean),
        )
        # a Gaussian proposal with the exact covariance at a near-posterior
        # mean: the log-ratios are near-constant, so the weights must be
        # near-uniform (ESS ≈ S). khat itself is NOT asserted — a GPD fit
        # on a near-degenerate tail is unreliable noise (the same
        # perfect-fit artifact optimizer='auto' ranks by ESS, see
        # multipath.py _khat)
        p = r2.psis_result
        assert float(p.ess) > 0.9 * p.weights.size

    def test_diag_installs_conditional_variances(self, result):
        """method='diag' variance = 1 / diag(precision) — the Gaussian
        conditional variances."""
        from pathfinder_tpu.multipath import laplace_resample

        res, target = result
        r2 = laplace_resample(res, 80, method="diag")
        want = 1.0 / np.diag(np.linalg.inv(target.cov))
        for k in range(r2.nruns):
            got = np.asarray(r2.fit_distribution.component(k).cov.diag())
            np.testing.assert_allclose(got, want, rtol=2e-3)

    def test_result_fields_and_non_mutation(self, result):
        from pathfinder_tpu.multipath import laplace_resample

        res, _ = result
        r2 = laplace_resample(res, 70, method="diag")
        assert r2.draws.shape == (5, 70)
        assert r2.draw_component_ids.shape == (70,)
        assert r2.psis_result is not res.psis_result
        assert r2.fit_distribution is not res.fit_distribution
        # fresh draws: not from the stored pool
        pool = np.asarray(res.draws_per_component).reshape(-1, 5)
        cols = np.asarray(r2.draws).T
        overlap = sum(
            bool(np.isclose(pool, c[None, :]).all(axis=1).any()) for c in cols
        )
        assert overlap == 0
        # per-path views reflect the corrected covariance
        pr = r2.path_result(0)
        np.testing.assert_array_equal(
            np.asarray(pr.fit_distribution.cov.diag()),
            np.asarray(r2.fit_distribution.component(0).cov.diag()),
        )
        # original untouched
        assert res.draws.shape == (5, 100)
        assert res.fit_distribution.components.cov.B.shape[-1] > 0

    def test_deterministic_given_key_and_chains_with_resample(self, result):
        from pathfinder_tpu.multipath import laplace_resample

        res, _ = result
        a = laplace_resample(res, 40, key=jax.random.key(7))
        b = laplace_resample(res, 40, key=jax.random.key(7))
        np.testing.assert_array_equal(np.asarray(a.draws), np.asarray(b.draws))
        # chained plain resample reuses the corrected pool + PSIS
        r3 = resample(a, 30)
        assert r3.psis_result is a.psis_result
        pool = np.asarray(a.draws_per_component).reshape(-1, 5)
        for col in np.asarray(r3.draws).T[:5]:
            assert np.isclose(pool, col[None, :]).all(axis=1).any()

    def test_importance_false_and_bad_method(self, result):
        from pathfinder_tpu.multipath import laplace_resample

        res, _ = result
        r2 = laplace_resample(res, 30, importance=False)
        assert r2.psis_result is None
        with pytest.raises(ValueError, match="diag.*full|full.*diag"):
            laplace_resample(res, 30, method="newton")

    def test_user_hess_callable_is_used(self, result):
        from pathfinder_tpu.multipath import laplace_resample

        res, _ = result
        # hess = -2I → negH = 2I → diag var = 0.5 everywhere
        r2 = laplace_resample(
            res, 30, method="diag",
            hess=lambda x: -2.0 * jnp.eye(x.shape[0], dtype=x.dtype),
        )
        for k in range(r2.nruns):
            np.testing.assert_allclose(
                np.asarray(r2.fit_distribution.component(k).cov.diag()),
                0.5, rtol=1e-6,
            )

    def test_dense_dim_warning(self, result, monkeypatch):
        import pathfinder_tpu.ops.optimizers as opt_mod
        from pathfinder_tpu.multipath import laplace_resample

        res, _ = result
        monkeypatch.setattr(opt_mod, "NEWTON_DENSE_DIM_WARN", 3)
        with pytest.warns(UserWarning, match="materializes"):
            laplace_resample(res, 30, method="diag")

    def test_ndraws_per_run_override(self, result):
        from pathfinder_tpu.multipath import laplace_resample

        res, _ = result
        r2 = laplace_resample(res, 60, ndraws_per_run=37)
        assert r2.draws_per_component.shape == (4, 37, 5)
        assert r2.psis_result.log_weights.size == 4 * 37


def test_laplace_covariances_diag_fallback_and_saddle_free():
    """Unit test of the corrected-covariance construction: non-positive
    diag(−H) coordinates fall back to the fitted diagonal; negative
    eigenvalues keep their scale (variance 1/|λ|) under method='full'."""
    from pathfinder_tpu.multipath import _laplace_covariances

    # component 0: −H = diag(4, −1, 2) → coord 1 falls back to fit_diag
    negH = jnp.stack([
        jnp.diag(jnp.array([4.0, -1.0, 2.0])),
        jnp.diag(jnp.array([1.0, 1.0, 1.0])),
    ])
    fit_diag = jnp.full((2, 3), 7.0)
    cov = _laplace_covariances(negH, fit_diag, "diag")
    np.testing.assert_allclose(
        np.asarray(jax.vmap(lambda c: c.diag())(cov)),
        [[0.25, 7.0, 0.5], [1.0, 1.0, 1.0]],
        rtol=1e-6,
    )
    # full with a negative eigenvalue: |λ| spectrum → variance 1/|λ|
    cov_full = _laplace_covariances(negH, fit_diag, "full")
    dense0 = np.asarray(jax.vmap(lambda c: c.to_dense())(cov_full))[0]
    np.testing.assert_allclose(
        np.diag(dense0), [0.25, 1.0, 0.5], rtol=1e-5
    )
    assert np.isfinite(dense0).all()
    # a degenerate Hessian (all-zero: a plateau, or NaN: a failed path's
    # garbage mean) has no usable curvature — that component falls back
    # WHOLE to the fitted diagonal instead of producing inf/NaN draws
    negH_bad = jnp.stack([
        jnp.zeros((3, 3)),
        jnp.full((3, 3), jnp.nan),
    ])
    for method in ("diag", "full"):
        cov_bad = _laplace_covariances(negH_bad, fit_diag, method)
        dense = np.asarray(jax.vmap(lambda c: c.to_dense())(cov_bad))
        np.testing.assert_allclose(
            dense, np.stack([np.diag([7.0] * 3)] * 2), rtol=1e-6
        )
    with pytest.raises(ValueError, match="method"):
        _laplace_covariances(negH, fit_diag, "banana")


def test_laplace_resample_transform_aware():
    """The correction must work on a transform-aware (BayesModel) result:
    Hessians of the LINKED density at unconstrained means, constrained
    draws rebuilt (every result-consuming entry point gets a
    transform-aware test)."""
    from pathfinder_tpu.models.bayes import BayesModel, HalfNormal, Normal
    from pathfinder_tpu.multipath import laplace_resample

    obs = np.array([0.4, 1.1, -0.2, 0.8], dtype=np.float32)
    model = BayesModel(
        {"mu": Normal(0.0, 5.0), "sigma": HalfNormal(2.0)},
        loglikelihood=lambda p: jnp.sum(
            -0.5 * ((obs - p["mu"]) / p["sigma"]) ** 2 - jnp.log(p["sigma"])
        ),
    )
    res = multipathfinder(
        model, 100, key=jax.random.key(0), nruns=4, maxiters=40
    )
    r2 = laplace_resample(res, 60, method="full")
    assert r2.draws.shape == (2, 60)
    assert isinstance(r2.draws_transformed, dict)
    sigma = np.asarray(r2.draws_transformed["sigma"])
    assert sigma.shape[-1] == 60
    assert (sigma > 0).all(), "constrained draws must satisfy the support"
    k = float(r2.psis_result.pareto_shape)
    assert k != k or np.isfinite(k)


def test_optimizer_auto_laplace_escalation():
    """auto_laplace applies the Laplace covariance correction to the
    winner when no candidate reached the k̂ threshold, and keeps it only
    if the diagnostic improves."""
    from pathfinder_tpu.multipath import laplace_resample

    target = CorrelatedGaussian(5, seed=2)
    kw = dict(
        key=jax.random.key(31), nruns=4, maxiters=60, history_length=5,
        optimizer="auto", auto_optimizers=("lbfgs",),
    )
    # force the escalation path with an impossible threshold
    r_base = multipathfinder(target, 100, auto_khat_early_exit=None, **kw)
    r_esc = multipathfinder(
        target, 100, auto_khat_early_exit=-1.0, auto_laplace=True, **kw
    )
    k_base = float(r_base.psis_result.pareto_shape)
    k_esc = float(r_esc.psis_result.pareto_shape)
    # the escalated result is never worse (kept only on improvement)
    assert k_esc <= k_base or np.isnan(k_base)
    if k_esc < k_base:
        # the kept correction must BE the laplace_resample of the winner
        # (same keys → bit-identical draws)
        expect = laplace_resample(r_base, 100, method="diag")
        np.testing.assert_array_equal(
            np.asarray(r_esc.draws), np.asarray(expect.draws)
        )
        assert r_esc.fit_distribution.components.cov.B.shape[-1] == 0
    # validation: auto-mode-only kwarg, and bad values fail fast
    with pytest.raises(ValueError, match="requires optimizer='auto'"):
        multipathfinder(
            target, 10, key=jax.random.key(0), nruns=2, maxiters=10,
            auto_laplace=True,
        )
    with pytest.raises(ValueError, match="auto_laplace must be"):
        multipathfinder(
            target, 10, key=jax.random.key(0), nruns=2, maxiters=10,
            optimizer="auto", auto_laplace="banana",
        )


def test_optimizer_auto_laplace_not_applied_below_threshold():
    """A winner already under the threshold skips the correction — the
    returned result is exactly the plain auto result."""
    target = StandardNormal(4)
    kw = dict(key=jax.random.key(15), nruns=4, maxiters=40)
    r_plain = multipathfinder(target, 60, optimizer="auto",
                              auto_optimizers=("lbfgs",), **kw)
    r_laplace = multipathfinder(
        target, 60, optimizer="auto", auto_optimizers=("lbfgs",),
        auto_laplace=True, **kw
    )
    np.testing.assert_array_equal(
        np.asarray(r_plain.draws), np.asarray(r_laplace.draws)
    )
    # the fitted (uncorrected) covariances travel with the result
    assert r_laplace.fit_distribution.components.cov.B.shape[-1] > 0


class TestBadKhatHint:
    """A bad/very-bad Pareto-k̂ verdict surfaces a one-line actionable
    remedy hint in the warning stream and the repr (beyond reference —
    the reference only prints the verdict, ``src/multipath.jl:54-63``;
    the remedies are this repo's measured ones)."""

    @staticmethod
    def _fake_psis(khat, n):
        from pathfinder_tpu.ops.psis import PSISResult

        lw = jnp.full((n,), -jnp.log(float(n)))
        return PSISResult(
            log_weights=lw,
            weights=jnp.exp(lw),
            pareto_shape=jnp.asarray(float(khat)),
            tail_length=max(1, n // 5),
            reff=1.0,
        )

    def test_driver_warns_and_repr_hints(self, monkeypatch):
        import pathfinder_tpu.multipath as mp

        # nruns=2, ndraws=40 → ndraws_per_run=20 → pool of 40 weights
        monkeypatch.setattr(
            mp, "_compute_psis_result", lambda *a, **k: self._fake_psis(1.5, 40)
        )
        with pytest.warns(UserWarning, match="measured remedies"):
            res, _ = run_multi(nruns=2, ndraws=40)
        assert "hint: k-hat > 0.7" in repr(res)
        # the un-tried remedies are all named
        with pytest.warns(UserWarning) as rec:
            run_multi(nruns=2, ndraws=40)
        msgs = [str(w.message) for w in rec if "unreliable" in str(w.message)]
        assert len(msgs) == 1
        assert "optimizer='auto'" in msgs[0]
        assert "laplace_resample" in msgs[0]
        assert "warm_start_chains" in msgs[0]

    def test_auto_winner_warns_once_with_adapted_hint(self, monkeypatch):
        import pathfinder_tpu.multipath as mp

        monkeypatch.setattr(
            mp, "_compute_psis_result", lambda *a, **k: self._fake_psis(0.9, 40)
        )
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            res, _ = run_multi(nruns=2, ndraws=40, optimizer="auto")
        hints = [w for w in rec if "unreliable" in str(w.message)]
        # candidate sub-runs are suppressed; only the winning result warns
        assert len(hints) == 1
        msg = str(hints[0].message)
        # already tried the optimizer competition — don't re-suggest it
        assert "optimizer='auto'" not in msg
        assert "laplace_resample" in msg
        assert "warm_start_chains" in msg

    def test_good_verdict_no_hint(self, monkeypatch):
        import pathfinder_tpu.multipath as mp

        monkeypatch.setattr(
            mp, "_compute_psis_result", lambda *a, **k: self._fake_psis(0.3, 40)
        )
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            res, _ = run_multi(nruns=2, ndraws=40)
        assert not [w for w in rec if "unreliable" in str(w.message)]
        assert "hint:" not in repr(res)


class TestChunkedLaunches:
    """``max_paths_per_launch`` splits large path batches into sequential
    launches of one fixed-shape program (bounding the lanes of any one
    compiled program). Keys depend only on the path
    id, so no randomness or decision changes; a fixed cap is fully
    deterministic, and chunked-vs-unchunked agree up to XLA's
    per-batch-size codegen rounding (measured ≤ 3e-6 on this target)."""

    def test_matches_unchunked(self):
        res_full, _ = run_multi(key=4, nruns=10, ndraws=100)
        res_chunk, _ = run_multi(
            key=4, nruns=10, ndraws=100, max_paths_per_launch=4
        )
        # algorithmic decisions identical (ELBO winner per path)
        np.testing.assert_array_equal(
            np.asarray(res_full.states.fit_iteration),
            np.asarray(res_chunk.states.fit_iteration),
        )
        np.testing.assert_array_equal(
            np.asarray(res_full.states.success),
            np.asarray(res_chunk.states.success),
        )
        # trajectories/draws agree up to XLA per-batch-size rounding
        np.testing.assert_allclose(
            np.asarray(res_full.draws), np.asarray(res_chunk.draws),
            atol=1e-4, rtol=1e-4,
        )
        # a fixed cap is fully deterministic
        res_chunk2, _ = run_multi(
            key=4, nruns=10, ndraws=100, max_paths_per_launch=4
        )
        np.testing.assert_array_equal(
            np.asarray(res_chunk.draws), np.asarray(res_chunk2.draws)
        )

    def test_chunked_under_mesh(self):
        mesh = paths_mesh()
        n_dev = mesh.devices.size
        res_full, _ = run_multi(key=4, nruns=2 * n_dev + 3, ndraws=100)
        res_chunk, _ = run_multi(
            key=4, nruns=2 * n_dev + 3, ndraws=100,
            mesh=mesh, max_paths_per_launch=n_dev,
        )
        np.testing.assert_array_equal(
            np.asarray(res_full.states.success),
            np.asarray(res_chunk.states.success),
        )
        np.testing.assert_allclose(
            np.asarray(res_full.draws), np.asarray(res_chunk.draws),
            atol=1e-4, rtol=1e-4,
        )

    def test_cap_rounds_down_to_mesh_divisible(self):
        from pathfinder_tpu.parallel.sharding import chunk_launches

        mesh = paths_mesh()
        n_dev = mesh.devices.size
        calls = []

        def fake_exec(keys, x0s, target, config):
            calls.append(keys.shape[0])
            return jnp.zeros((keys.shape[0], 1))

        # cap = n_dev + 1 rounds down to n_dev per launch
        run = chunk_launches(fake_exec, n_dev + 1, mesh)
        keys = jax.random.split(jax.random.key(0), 2 * n_dev + 1)
        x0s = jnp.zeros((2 * n_dev + 1, 3))
        out = run(keys, x0s, None, None)
        assert out.shape[0] == 2 * n_dev + 1
        assert all(c == n_dev for c in calls) and len(calls) == 3

    def test_invalid_cap(self):
        from pathfinder_tpu.parallel.sharding import chunk_launches

        with pytest.raises(ValueError, match="positive"):
            chunk_launches(lambda *a: None, 0)

    def test_auto_cap_past_single_program_ceiling(self, monkeypatch):
        """``max_paths_per_launch=None`` resolves transparently: past the
        single-program ceiling (sharding.SINGLE_PROGRAM_MAX_K) the
        driver chunks at sharding.DEFAULT_LAUNCH_CAP on its own, records the
        resolved cap on the result (so resample/laplace PSIS recomputes
        stay block-wise), and matches an explicit-cap run bit-for-bit."""
        from pathfinder_tpu.parallel import sharding

        monkeypatch.setattr(sharding, "SINGLE_PROGRAM_MAX_K", 6)
        monkeypatch.setattr(sharding, "DEFAULT_LAUNCH_CAP", 4)
        res_auto, _ = run_multi(key=4, nruns=10, ndraws=100)
        assert res_auto.max_paths_per_launch == 4
        res_explicit, _ = run_multi(
            key=4, nruns=10, ndraws=100, max_paths_per_launch=4
        )
        np.testing.assert_array_equal(
            np.asarray(res_auto.draws), np.asarray(res_explicit.draws)
        )
        # below the ceiling: single program, nothing recorded
        monkeypatch.setattr(sharding, "SINGLE_PROGRAM_MAX_K", 64)
        res_small, _ = run_multi(key=4, nruns=10, ndraws=100)
        assert res_small.max_paths_per_launch is None
        # an explicit cap >= nruns forces a single program (documented
        # opt-out) even past the ceiling
        monkeypatch.setattr(sharding, "SINGLE_PROGRAM_MAX_K", 6)
        res_forced, _ = run_multi(
            key=4, nruns=10, ndraws=100, max_paths_per_launch=10
        )
        np.testing.assert_array_equal(
            np.asarray(res_small.draws), np.asarray(res_forced.draws)
        )


def test_chunked_psis_matches_unchunked():
    """The tail analog of chunked launches: block-computed own-component
    log ratios feed one pooled psis() fit — same k-hat and weights as the
    monolithic program (up to XLA per-batch-size rounding), including
    when the chunk does not divide K."""
    from pathfinder_tpu.multipath import (
        _compute_psis_result,
        _select_component_fits,
    )

    res, target = run_multi(key=7, nruns=10, ndraws=100)
    comps = _select_component_fits(res.states)
    draws_knd = jnp.swapaxes(res.states.draws, 1, 2)
    full = _compute_psis_result(target.logp, comps, draws_knd)
    for chunk in (3, 5, 16):  # non-divisor, divisor, > K
        blocked = _compute_psis_result(
            target.logp, comps, draws_knd, chunk=chunk
        )
        np.testing.assert_allclose(
            float(full.pareto_shape), float(blocked.pareto_shape),
            rtol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(full.weights), np.asarray(blocked.weights),
            rtol=1e-5, atol=1e-9,
        )


class TestOffloadLaunches:
    """``offload_launches`` streams each chunk's output to host RAM as it
    completes, so per-path state never accumulates in HBM — host memory
    becomes the paths-axis ceiling (third serving-scale lever; measured
    K=32768 at d=1000 RESOURCE_EXHAUSTEDs on-device but runs offloaded).
    Device→host round trips preserve bits, so every output is
    bit-identical to the on-device chunked run."""

    def test_bit_identical_and_host_leaves(self):
        res_dev, _ = run_multi(
            key=8, nruns=10, ndraws=100, max_paths_per_launch=4,
            offload_launches=False,
        )
        res_off, _ = run_multi(
            key=8, nruns=10, ndraws=100, max_paths_per_launch=4,
            offload_launches=True,
        )
        # per-path state lives on host; typed PRNG-key leaves (8 B/path,
        # not numpy-convertible) stay on device
        assert isinstance(res_off.states.draws, np.ndarray)
        assert isinstance(res_off.states.fit_iteration, np.ndarray)
        assert isinstance(res_off.states.key, jax.Array)
        assert isinstance(res_dev.states.draws, jax.Array)
        # bit-identical outputs end to end
        np.testing.assert_array_equal(
            np.asarray(res_dev.draws), np.asarray(res_off.draws)
        )
        np.testing.assert_array_equal(
            np.asarray(res_dev.draw_component_ids),
            np.asarray(res_off.draw_component_ids),
        )
        np.testing.assert_array_equal(
            np.asarray(res_dev.states.fit_iteration),
            res_off.states.fit_iteration,
        )
        assert float(res_dev.psis_result.pareto_shape) == float(
            res_off.psis_result.pareto_shape
        )

    def test_single_launch_explicit_true_offloads(self):
        # explicit True moves even an un-chunked launch's output to host
        # (frees HBM for whatever runs next); auto (None) never engages
        # without chunking
        res, _ = run_multi(key=8, nruns=4, ndraws=50, offload_launches=True)
        assert isinstance(res.states.draws, np.ndarray)
        assert isinstance(res.states.key, jax.Array)
        res_auto, _ = run_multi(key=8, nruns=4, ndraws=50)
        assert isinstance(res_auto.states.draws, jax.Array)
        np.testing.assert_array_equal(
            np.asarray(res_auto.draws), np.asarray(res.draws)
        )

    def test_auto_threshold_is_per_device_on_mesh(self, monkeypatch):
        """HBM is per-device: a mesh sharding the paths axis over n
        devices accumulates 1/n of the bytes per device, so the auto rule
        scales the threshold by the mesh's paths-axis size (a global-bytes
        rule would gather multi-chip runs to host while per-device HBM is
        nearly empty)."""
        from pathfinder_tpu.parallel import sharding

        mesh = paths_mesh()
        n_dev = mesh.devices.size
        res_probe, _ = run_multi(
            key=8, nruns=4 * n_dev, ndraws=100, mesh=mesh,
            max_paths_per_launch=n_dev,
        )
        chunk_bytes = sum(
            leaf.size * leaf.dtype.itemsize
            for leaf in jax.tree_util.tree_leaves(res_probe.states)
        ) // 4  # 4 chunks accumulated
        # threshold = half the global bytes: global exceeds it (offload
        # when unsharded) but per-device bytes (1/n_dev of global) do not
        monkeypatch.setattr(
            sharding, "OFFLOAD_AUTO_BYTES", (chunk_bytes * 4) // 2
        )
        res_mesh, _ = run_multi(
            key=8, nruns=4 * n_dev, ndraws=100, mesh=mesh,
            max_paths_per_launch=n_dev,
        )
        assert isinstance(res_mesh.states.draws, jax.Array)
        # the same run without a mesh accumulates everything on one
        # device and must offload under the same threshold
        res_one, _ = run_multi(
            key=8, nruns=4 * n_dev, ndraws=100, max_paths_per_launch=n_dev
        )
        assert isinstance(res_one.states.draws, np.ndarray)

    def test_auto_threshold(self, monkeypatch):
        """``offload_launches=None`` (the default) offloads iff the
        accumulated launch outputs would exceed OFFLOAD_AUTO_BYTES,
        decided from the first chunk's concrete (post-slim) sizes."""
        from pathfinder_tpu.parallel import sharding

        monkeypatch.setattr(sharding, "OFFLOAD_AUTO_BYTES", 0)
        res_small, _ = run_multi(
            key=8, nruns=10, ndraws=100, max_paths_per_launch=4
        )
        assert isinstance(res_small.states.draws, np.ndarray)
        monkeypatch.setattr(sharding, "OFFLOAD_AUTO_BYTES", 1 << 60)
        res_big, _ = run_multi(
            key=8, nruns=10, ndraws=100, max_paths_per_launch=4
        )
        assert isinstance(res_big.states.draws, jax.Array)
        np.testing.assert_array_equal(
            np.asarray(res_big.draws), np.asarray(res_small.draws)
        )

    def test_auto_never_offloads_without_a_memory_limit(self):
        """The CPU backend reports no memory limit, so the default
        (``offload_launches=None``) keeps chunked outputs on the device."""
        res, _ = run_multi(
            key=8, nruns=10, ndraws=100, max_paths_per_launch=4
        )
        assert isinstance(res.states.draws, jax.Array)

    def test_retry_merge_on_host(self):
        """Retry rounds merge compacted device batches into the
        host-resident states in place — same results as on-device."""
        kw = dict(_RETRY_KW, max_paths_per_launch=2)
        r_dev = multipathfinder(
            _nan_wall_logp, 100, offload_launches=False, **kw
        )
        r_off = multipathfinder(
            _nan_wall_logp, 100, offload_launches=True, **kw
        )
        assert np.asarray(r_dev.num_tries).max() > 1  # retries fired
        assert isinstance(r_off.states.draws, np.ndarray)
        np.testing.assert_array_equal(
            np.asarray(r_dev.num_tries), np.asarray(r_off.num_tries)
        )
        np.testing.assert_array_equal(
            np.asarray(r_dev.draws), np.asarray(r_off.draws)
        )

    def test_composes_slim_resample_laplace_serialize(self, tmp_path):
        from pathfinder_tpu.multipath import laplace_resample
        from pathfinder_tpu.utils.serialize import load_result, save_result

        res, target = run_multi(
            key=9, nruns=8, ndraws=100, keep_traces=False,
            max_paths_per_launch=3, offload_launches=True,
        )
        assert isinstance(res.states.draws, np.ndarray)
        res2 = resample(res, 64)
        assert res2.draws.shape == (5, 64)
        cor = laplace_resample(res, 64, method="diag")
        assert cor.draws.shape == (5, 64)
        path = tmp_path / "offload.npz"
        save_result(path, res)
        back = load_result(path, fn=target)
        np.testing.assert_array_equal(
            np.asarray(back.draws), np.asarray(res.draws)
        )


class TestKeepTraces:
    """``keep_traces=False`` drops trajectory arrays per launch — the
    serving-scale HBM lever (with chunked launches, peak HBM = one chunk's
    trace + slim states; see ``_slim_traces``). Slimming happens outside
    the jitted core, so every output is bit-identical to the default."""

    def test_bit_identical_outputs(self):
        res_full, _ = run_multi(key=5, nruns=6, ndraws=100)
        res_slim, _ = run_multi(
            key=5, nruns=6, ndraws=100, keep_traces=False
        )
        np.testing.assert_array_equal(
            np.asarray(res_full.draws), np.asarray(res_slim.draws)
        )
        np.testing.assert_array_equal(
            np.asarray(res_full.states.fit_iteration),
            np.asarray(res_slim.states.fit_iteration),
        )
        assert float(res_full.psis_result.pareto_shape) == float(
            res_slim.psis_result.pareto_shape
        )

    def test_trace_dropped_scalars_kept_and_guard(self):
        res, _ = run_multi(key=5, nruns=4, ndraws=50, keep_traces=False)
        # trajectory arrays are zero-length; scalar diagnostics survive
        assert res.states.trace.xs.shape[1] == 0
        assert res.states.trace.gradients.shape[1] == 0
        assert res.states.trace.log_densities.shape[1] == 0
        assert int(np.asarray(res.states.trace.num_valid).min()) >= 1
        pr = res.path_result(0)
        repr(pr)  # repr reads num_valid, not the arrays
        assert pr.num_fn_evals > 0
        with pytest.raises(ValueError, match="keep_traces"):
            pr.fit_distributions
        with pytest.raises(ValueError, match="keep_traces"):
            pr.elbo_estimates

    def test_composes_with_chunking_resample_laplace(self, tmp_path):
        from pathfinder_tpu.multipath import laplace_resample, resample
        from pathfinder_tpu.utils.serialize import load_result, save_result

        res_full, _ = run_multi(key=6, nruns=8, ndraws=100)
        res, target = run_multi(
            key=6, nruns=8, ndraws=100, keep_traces=False,
            max_paths_per_launch=3,
        )
        # chunked+slim agrees with the default up to XLA per-batch-size
        # codegen rounding (same tolerance as TestChunkedLaunches)
        np.testing.assert_allclose(
            np.asarray(res_full.draws), np.asarray(res.draws),
            atol=1e-4, rtol=1e-4,
        )
        res2 = resample(res, 64)
        assert res2.draws.shape == (5, 64)
        cor = laplace_resample(res, 64, method="diag")
        assert cor.draws.shape == (5, 64)
        path = tmp_path / "slim.npz"
        save_result(path, res)
        back = load_result(path, fn=target)
        np.testing.assert_array_equal(
            np.asarray(back.draws), np.asarray(res.draws)
        )
        assert back.states.trace.xs.shape[1] == 0
