"""Pathfinder (parallel quasi-Newton VI) in JAX.

A from-scratch JAX/XLA implementation with the capability surface of the
reference Julia package (mlcolab/Pathfinder.jl), redesigned for batched
accelerator execution: fixed-shape ``lax.scan``/``while_loop``
optimization, masked low-rank covariance factors, and
``vmap``/``shard_map`` path parallelism.
"""

from pathfinder_tpu.models.bayes import BayesModel
from pathfinder_tpu.models.protocol import LogDensity, as_log_density
from pathfinder_tpu.multipath import (
    MultiPathfinderResult,
    laplace_resample,
    multipathfinder,
    resample,
)
from pathfinder_tpu.ops.mvnormal import MvNormal, UniformMixture
from pathfinder_tpu.ops.psis import PSISResult, psis
from pathfinder_tpu.ops.woodbury import WoodburyPDMat, pdfactorize, pdunfactorize
from pathfinder_tpu.parallel.sharding import (
    make_path_executor,
    paths_dim_mesh,
    paths_mesh,
)
from pathfinder_tpu.singlepath import (
    PathfinderConfig,
    PathfinderResult,
    pathfinder,
)
from pathfinder_tpu.utils.diagnostics import ess_bulk, ess_tail, split_rhat, summarize

__version__ = "0.4.0"

__all__ = [
    "pathfinder",
    "multipathfinder",
    "resample",
    "laplace_resample",
    "PathfinderResult",
    "MultiPathfinderResult",
    "PathfinderConfig",
    "LogDensity",
    "as_log_density",
    "BayesModel",
    "MvNormal",
    "UniformMixture",
    "WoodburyPDMat",
    "pdfactorize",
    "pdunfactorize",
    "PSISResult",
    "psis",
    "paths_mesh",
    "paths_dim_mesh",
    "make_path_executor",
    "ess_bulk",
    "ess_tail",
    "split_rhat",
    "summarize",
]
