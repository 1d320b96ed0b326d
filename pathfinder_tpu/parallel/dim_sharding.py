"""Parameter-dimension sharding: scale Pathfinder to d too large for one chip.

SURVEY §5 identifies the reference's scaling axes: it scales in ``d`` by
keeping covariances in diag + low-rank form (never O(d²)); the mesh analog of
"sequence parallelism" is sharding the ``d`` axis of θ, gradients, ``B``,
and draws across a mesh. Every Woodbury operation is embarrassingly
row-parallel except m-length reductions (``Xᵀx``, norms), which become
single tiny ``psum``-style collectives.

Implementation follows the scaling-book recipe: **annotate shardings, let
XLA insert the collectives** — no hand-written communication. The helpers
here construct the shardings; the existing `WoodburyPDMat` / `MvNormal` /
`pathfinder_core` code runs unchanged under them, because everything is
already expressed as row-wise elementwise ops + (d,m)ᵀ(d,·) contractions
that GSPMD partitions cleanly.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["dim_mesh", "shard_dim", "dim_sharding_for"]

DIM_AXIS = "dim"


def dim_mesh(devices=None) -> Mesh:
    """A 1-D mesh over the given (or all) devices with a ``dim`` axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (DIM_AXIS,))


def dim_sharding_for(mesh: Mesh, leaf) -> NamedSharding:
    """Sharding that splits the leading axis of ``leaf`` over the ``dim``
    mesh axis (scalars replicate). Note this shards *whatever* axis 0 is —
    the is-this-leaf-actually-d filtering (replicating m×m cores etc.)
    lives in :func:`shard_dim`, which is the API to use on whole trees."""
    if leaf.ndim == 0:
        return NamedSharding(mesh, P())
    spec = [None] * leaf.ndim
    spec[0] = DIM_AXIS
    return NamedSharding(mesh, P(*spec))


def shard_dim(tree, mesh: Mesh, dim: Optional[int] = None):
    """Device-put a pytree with every leaf whose leading axis equals ``dim``
    (default: the largest mesh-divisible leading axis among the leaves)
    sharded over the ``dim`` axis, everything else replicated.

    Typical use: shard ``x0``/``B``-like operands before a jitted Woodbury /
    Pathfinder computation; XLA propagates the sharding through the whole
    program and inserts the m-length reductions as collectives.
    """
    n_dev = mesh.devices.size
    if dim is not None and dim % n_dev != 0:
        # an explicit dim the mesh cannot divide would silently replicate
        # every leaf — the exact OOM/perf problem shard_dim exists to avoid
        raise ValueError(
            f"dim={dim} is not divisible by the {n_dev}-device mesh; pad "
            f"the parameter dimension to a multiple of {n_dev} (e.g. "
            "jnp.pad) or use a divisible mesh."
        )
    if dim is None:
        # default: only the LARGEST shardable leading axis is the parameter
        # dimension; smaller leading axes (m×m cores, scalars) replicate
        sizes = [
            leaf.shape[0]
            for leaf in jax.tree_util.tree_leaves(tree)
            if hasattr(leaf, "ndim")
            and getattr(leaf, "ndim", 0) >= 1
            and leaf.shape[0] % n_dev == 0
            and leaf.shape[0] > 1
        ]
        dim = max(sizes) if sizes else -1
        if dim == -1:
            import warnings

            warnings.warn(
                f"shard_dim: no leaf has a leading axis divisible by the "
                f"{n_dev}-device mesh; every leaf will be REPLICATED, not "
                "sharded. Pass dim= explicitly or pad the arrays."
            )

    elif dim >= 0 and not any(
        getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == dim
        for leaf in jax.tree_util.tree_leaves(tree)
    ):
        # an explicit mesh-divisible dim matching no leaf would silently
        # replicate everything — same failure the divisibility check guards
        raise ValueError(
            f"dim={dim} matches no leaf's leading axis; leading axes are "
            f"{sorted({leaf.shape[0] for leaf in jax.tree_util.tree_leaves(tree) if getattr(leaf, 'ndim', 0) >= 1})}."
        )

    def place(leaf):
        leaf = jax.numpy.asarray(leaf)
        is_dim = (
            leaf.ndim >= 1
            and leaf.shape[0] == dim
            and leaf.shape[0] % n_dev == 0
        )
        if is_dim:
            return jax.device_put(leaf, dim_sharding_for(mesh, leaf))
        return jax.device_put(leaf, NamedSharding(mesh, P()))

    return jax.tree_util.tree_map(place, tree)
