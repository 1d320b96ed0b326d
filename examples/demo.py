"""End-to-end demo: Pathfinder → PSIS → NUTS warm start on a real posterior.

Run on any backend (the GPU when JAX finds one; set ``JAX_PLATFORMS=cpu``
for the CPU):

    python examples/demo.py
"""

import jax
import jax.numpy as jnp
import numpy as np

from pathfinder_tpu import (
    multipathfinder,
    pathfinder,
    resample,
    summarize,
)
from pathfinder_tpu.integrations import nuts_warm_start
from pathfinder_tpu.models import LogisticRegression, german_credit_synthetic


def main():
    # a Bayesian logistic regression posterior (d = 25)
    X, y, beta_true = german_credit_synthetic(n=1000, d=25, seed=0)
    target = LogisticRegression(X.astype(np.float32), y.astype(np.float32))

    # ---- single-path -----------------------------------------------------
    res = pathfinder(target, key=jax.random.key(0), ndraws=1000, maxiters=100)
    print(res)
    print(f"  logp+grad evaluations: {res.num_fn_evals}")

    # ---- multi-path + PSIS ------------------------------------------------
    mres = multipathfinder(
        target, 4000, key=jax.random.key(1), nruns=16, maxiters=100,
        progress=True,
    )
    print(mres)
    print(f"  PSIS ESS: {float(mres.psis_result.ess):.0f}")

    # post-hoc: more draws without re-optimizing
    more = resample(mres, 10_000)
    print(f"  resampled to {more.draws.shape[1]} draws")

    # ---- NUTS warm start ---------------------------------------------------
    out = nuts_warm_start(
        jax.random.key(2), res, num_samples=1000, num_warmup=200
    )
    stats = summarize(out.samples[None])
    print(
        "NUTS: accept="
        f"{float(out.accept_stat.mean()):.2f} "
        f"mean tree depth={float(out.tree_depths.mean()):.1f} "
        f"min ESS={float(np.asarray(stats['ess_bulk']).min()):.0f} "
        f"max Rhat={float(np.asarray(stats['rhat']).max()):.3f}"
    )

    # Pathfinder means vs NUTS means
    pf_mean = np.asarray(mres.draws).mean(axis=1)
    nuts_mean = np.asarray(out.samples).mean(axis=0)
    print(f"max |pathfinder mean − NUTS mean| = {np.abs(pf_mean - nuts_mean).max():.3f}")


if __name__ == "__main__":
    import os

    # JAX reads JAX_COMPILATION_CACHE_DIR itself; otherwise keep the cache
    # in the checkout, where bench.py and chip_smoke.py keep theirs
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir",
            os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                ".jax_cache",
            ),
        )
    main()
