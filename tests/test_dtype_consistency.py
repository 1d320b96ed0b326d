"""f32 vs f64 whole-pipeline consistency.

The default dtype is float32; tests otherwise validate against f64 ground
truth op-by-op. This checks the END-TO-END contract (SURVEY §7 hard-part 3):
the f32 pipeline must land on the same fit, within single-precision
tolerances, as the f64 pipeline on a well-conditioned target.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pathfinder_tpu.models import CorrelatedGaussian
from pathfinder_tpu.multipath import multipathfinder
from pathfinder_tpu.singlepath import pathfinder


def test_singlepath_f32_matches_f64():
    d = 8
    target = CorrelatedGaussian(d, seed=5)
    r64 = pathfinder(
        target, key=jax.random.key(0), maxiters=60, history_length=d,
        ndraws_elbo=200, dtype=jnp.float64,
    )
    r32 = pathfinder(
        target, key=jax.random.key(0), maxiters=60, history_length=d,
        ndraws_elbo=200, dtype=jnp.float32,
    )
    assert r64.success and r32.success
    assert r32.draws.dtype == jnp.float32
    # both pipelines recover the target's moments
    np.testing.assert_allclose(
        r32.fit_distribution.mean, target.mean, atol=0.05
    )
    np.testing.assert_allclose(
        r64.fit_distribution.mean, target.mean, atol=0.05
    )
    # covariance quality in Frobenius norm (trajectories differ between
    # precisions, so elementwise equality is not the contract — approximation
    # quality is; f32 ELBO ties may pick an earlier iteration with a coarser
    # window, hence the looser f32 bound)
    def frob_err(r):
        return np.linalg.norm(
            np.asarray(r.fit_distribution.cov.to_dense()) - target.cov
        ) / np.linalg.norm(target.cov)

    assert frob_err(r64) < 0.2, frob_err(r64)
    assert frob_err(r32) < 0.5, frob_err(r32)
    # both pipelines' fit logdets are close to the true logdet
    true_ld = np.linalg.slogdet(target.cov)[1]
    for r in (r32, r64):
        assert abs(float(r.fit_distribution.cov.logdet()) - true_ld) < 1.0


def test_multipath_f32_khat_sane():
    target = CorrelatedGaussian(6, seed=6)
    res = multipathfinder(
        target, 500, key=jax.random.key(1), nruns=6, maxiters=50,
        history_length=6, dtype=jnp.float32,
    )
    assert res.draws.dtype == jnp.float32
    assert np.all(np.isfinite(np.asarray(res.draws)))
    assert float(res.psis_result.pareto_shape) < 0.7
