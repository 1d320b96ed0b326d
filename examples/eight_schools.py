"""Eight schools, end-to-end: the classic hierarchical Bayesian benchmark
through the whole framework — BayesModel (non-centered parameterization) →
multi-path Pathfinder → mixture-denominator importance resampling → NUTS
warm-started from the fit, with R-hat/ESS diagnostics.

Run: python examples/eight_schools.py   (GPU or CPU)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

# JAX reads JAX_COMPILATION_CACHE_DIR itself; otherwise keep the cache in
# the checkout, where bench.py and chip_smoke.py keep theirs
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".jax_cache"),
    )

from pathfinder_tpu import BayesModel, multipathfinder
from pathfinder_tpu.models.bayes import HalfCauchy, Normal
from pathfinder_tpu.integrations import WoodburyMetric, nuts_chains

# the data of Rubin (1981): estimated treatment effects and their SEs
y = jnp.asarray([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
sigma = jnp.asarray([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])


def loglik(p):
    theta = p["mu"] + p["tau"] * p["theta_raw"]  # non-centered
    return jnp.sum(-0.5 * ((y - theta) / sigma) ** 2)


model = BayesModel(
    {
        "mu": Normal(0.0, 5.0),
        "tau": HalfCauchy(5.0),  # Gelman (2006) scale prior
        "theta_raw": (Normal(0.0, 1.0), 8),
    },
    loglikelihood=loglik,
)

print(f"model: {model.dim} unconstrained parameters {model.names}")

# --- multi-path Pathfinder with the lower-variance mixture weights --------
res = multipathfinder(
    model, 4000, key=jax.random.key(0), nruns=16, maxiters=200,
    importance_denominator="mixture",
)
ch = res.draws_transformed
mu = np.asarray(ch["mu"])
tau = np.asarray(ch["tau"])
print(res)
khat = float(res.psis_result.pareto_shape)
print(f"  E[mu]  = {mu.mean():.2f}   E[tau] = {tau.mean():.2f}")
print(f"  Pareto k-hat = {khat:.2f} -> the diagnostic honestly flags that")
print("  importance weighting struggles on this funnel-like hierarchical")
print("  geometry: treat the draws as MCMC warm-start material, not as")
print("  final estimates (exactly the reference's recommended workflow).")

theta = (
    mu[:, None] + tau[:, None] * np.asarray(ch["theta_raw"])
)
print("  per-school posterior means:", np.round(theta.mean(axis=0), 1))
print("  raw observations:         ", np.asarray(y))

# --- NUTS warm-started from the fit (4 chains, distinct start draws) ------
# replace=False draws unique warm-start points from the stored PSIS
# weights (the documented initialization workflow); the metric comes from
# the component that produced the first resampled draw
from pathfinder_tpu.multipath import resample

init = resample(res, 4, replace=False, key=jax.random.key(7))
out, summary = nuts_chains(
    jax.random.key(1),
    jax.value_and_grad(res.logp),  # the linked unconstrained density
    WoodburyMetric.from_result(init),
    init.draws.T,
    num_samples=1000,
    num_warmup=500,
    adapt_mass_matrix=True,  # refine the metric during warmup
)
print(
    f"NUTS: max R-hat {float(np.max(np.asarray(summary['rhat']))):.3f}, "
    f"min bulk ESS {float(np.min(np.asarray(summary['ess_bulk']))):.0f}, "
    f"min tail ESS {float(np.min(np.asarray(summary['ess_tail']))):.0f}"
)
# constrained-space NUTS results via the model bijector
z = np.asarray(out.samples).reshape(-1, model.dim)
x = np.asarray(jax.vmap(model.bijector.forward)(jnp.asarray(z)))
mu_n, tau_n = x[:, 0], x[:, 1]
print(f"NUTS E[mu] = {mu_n.mean():.2f}, E[tau] = {tau_n.mean():.2f}")
# the warm-started sampler lands on the literature posterior
# (Rubin 1981 / Stan: E[mu] ~ 4.4, E[tau] ~ 3.6)
assert abs(mu_n.mean() - 4.4) < 1.0 and abs(tau_n.mean() - 3.6) < 1.5
print("OK: warm-started NUTS reproduces the reference posterior —")
print("    Pathfinder found the typical set and the metric in one pass,")
print("    NUTS refined it; the k-hat diagnostic told us to do exactly that.")
