"""Path parallelism over device meshes.

The reference's "parallel" axis is shared-memory task chunking over paths
(``_chunk_tmap``, ``src/multipath.jl:190-204``; inventory in SURVEY §2c).
The equivalent implemented here:

* **within a device**: ``vmap`` over the paths axis — all K optimizations,
  factorizations, and ELBO evaluations advance in lockstep as one batched
  program;
* **across devices**: ``shard_map`` of the vmapped core over a 1-D device
  mesh with the paths axis sharded — single-path Pathfinder needs **zero
  cross-device communication**, so each device runs its shard of paths
  alone; the only collectives in multipath are the implicit all-gathers of
  the tiny per-path fits and K·N log-ratio scalars consumed by
  PSIS/resampling, which XLA inserts at the jit boundary.

Determinism contract (reference ``src/multipath.jl:162``, tested at
``test/multipath.jl:107-140``): every path's randomness comes from
``fold_in(key, path_id)`` — the counter-based analog of the reference's
seeds-drawn-before-spawning — so the mesh shape changes no sampled
randomness. On the CPU backend results are bit-identical for any mesh
shape. On a GPU the per-device batch width selects other compiled code
whose rounding differs, and a trajectory can carry that into a different,
equally valid run (see the README's determinism contract).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from pathfinder_tpu.singlepath import pathfinder_core

__all__ = [
    "paths_mesh",
    "paths_dim_mesh",
    "make_path_executor",
    "pad_paths",
    "chunk_launches",
]

PATHS_AXIS = "paths"
DIM_AXIS = "dim"  # must match parallel.dim_sharding.DIM_AXIS


def paths_mesh(devices=None) -> Mesh:
    """A 1-D mesh over all (or the given) devices with a ``paths`` axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (PATHS_AXIS,))


def paths_dim_mesh(n_paths_axis: int, devices=None) -> Mesh:
    """A 2-D ``('paths', 'dim')`` mesh: the combined SPMD layout of SURVEY
    §2c — paths sharded over one axis (zero cross-device communication per
    path) AND the parameter dimension over the other (for ``d`` too large
    for one chip's share of the batch). Pass to ``multipathfinder(mesh=…)``;
    the executor routes it through GSPMD sharding annotations instead of
    ``shard_map`` (the scaling-book recipe: annotate, let XLA insert the
    m-length reduction collectives along the dim axis)."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if devices.size % n_paths_axis != 0:
        raise ValueError(
            f"{devices.size} devices do not factor into a "
            f"({n_paths_axis}, ·) paths×dim mesh"
        )
    return Mesh(
        devices.reshape(n_paths_axis, -1), (PATHS_AXIS, DIM_AXIS)
    )


# Large path counts are padded to a multiple of PATHS_ALIGN lanes, so
# nearby K share one batch width. Padding lanes run with their own keys
# and are discarded, so the choice changes no result; the values are not
# yet measured on the current GPU target.
PATHS_ALIGN = 256
PATHS_ALIGN_MIN_K = 2048

# Past SINGLE_PROGRAM_MAX_K lanes, ``multipathfinder`` transparently runs
# sequential launches of one fixed-shape ``DEFAULT_LAUNCH_CAP``-lane
# program instead of one program. An explicit ``max_paths_per_launch``
# always wins; pass a cap ≥ nruns to force a single program. Chunking
# changes no result (see :func:`chunk_launches`); the values are not yet
# measured on the current GPU target.
SINGLE_PROGRAM_MAX_K = 6144
DEFAULT_LAUNCH_CAP = 4096

# Host-offload auto threshold for chunked launches: when the accumulated
# launch outputs (n_chunks × the first chunk's concrete output bytes, per
# device) would exceed OFFLOAD_AUTO_FRACTION of the device's memory limit
# (``memory_stats()["bytes_limit"]``), stream each chunk's output to host
# RAM instead of letting chunks pile up on the device. An eighth leaves
# room for what is live beside the accumulated outputs: one in-flight
# launch's full buffers (trajectory traces, ELBO intermediates) and the
# device-side concatenation copy, which doubles the accumulated bytes.
# A backend that reports no limit (the CPU) never offloads automatically.
# OFFLOAD_AUTO_BYTES, when set, replaces the derived threshold.
OFFLOAD_AUTO_FRACTION = 1 / 8
OFFLOAD_AUTO_BYTES: Optional[int] = None


def offload_auto_bytes(device) -> Optional[int]:
    """Per-device byte threshold of ``chunk_launches(offload=None)``, or
    ``None`` when ``device`` reports no memory limit."""
    if OFFLOAD_AUTO_BYTES is not None:
        return OFFLOAD_AUTO_BYTES
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        return None
    return int(limit * OFFLOAD_AUTO_FRACTION)


def pad_paths(n: int, mesh: Optional[Mesh], align: bool = True) -> int:
    """Smallest K' ≥ n divisible by the mesh's ``paths`` axis (1 when
    unsharded) — and, for ``n ≥ PATHS_ALIGN_MIN_K``, by ``PATHS_ALIGN``
    (see the constants above).
    Padding lanes run with their own ``fold_in(key, path_id)`` keys and
    are discarded, so alignment changes no result."""
    size = 1
    if mesh is not None:
        size = dict(mesh.shape).get(PATHS_AXIS, mesh.devices.size)
    K = ((n + size - 1) // size) * size
    if align and K >= PATHS_ALIGN_MIN_K:
        a = PATHS_ALIGN * size // math.gcd(PATHS_ALIGN, size)
        K = ((K + a - 1) // a) * a
    return K


def chunk_launches(
    executor,
    cap: Optional[int],
    mesh: Optional[Mesh] = None,
    offload: Optional[bool] = False,
):
    """Wrap a path executor so batches larger than ``cap`` lanes run as
    sequential launches of ONE fixed-shape ``cap``-lane program.

    ``offload`` streams each launch's output to host RAM as it
    completes, so chunk outputs never accumulate on the device — host memory
    becomes the paths-axis ceiling instead of the device. The returned
    pytree then has numpy leaves (bit-identical values: a device→host
    round trip preserves bits); typed PRNG-key leaves stay on device
    (8 B/path under the default threefry impl, not convertible).
    Chunks are written into preallocated K-row host buffers (peak host
    usage = the pool itself, no concat doubling), and the next chunk is
    dispatched *before* the previous chunk's transfer blocks, so device
    compute and d2h transfer overlap (≤ 2 chunk outputs live on the
    device). ``offload=None`` decides automatically after dispatching the
    first chunk (from its aval sizes, no sync): offload iff the
    accumulated *per-device* bytes ``n_chunks × chunk_bytes /
    mesh_paths_size`` exceed :func:`offload_auto_bytes` of the first mesh
    device (the default device without a mesh) — device memory is a
    per-device resource, so a mesh that shards the paths axis raises the
    on-device ceiling proportionally. ``offload=True`` always offloads,
    including a single un-chunked launch (frees device memory for
    whatever runs next); with a multi-device mesh it gathers each
    launch's sharded output to the host (the cost host offload implies).

    Because every path's randomness comes from ``fold_in(key, path_id)``
    — keys are computed *before* the executor sees them — chunking the
    path axis changes no sampled randomness and no algorithmic decision.
    A fixed ``cap`` is fully deterministic (one compiled program, one
    launch order). Results across *different* caps (or vs the unchunked
    program) agree in exact arithmetic but not in rounding: XLA emits
    different code for different batch sizes (measured ≤ 3e-6 on f32 d=5
    trajectories on the CPU; on a GPU whole trajectories can diverge) —
    the same caveat the retry rounds' compacted batches already carry.

    ``cap`` is rounded DOWN to a mesh-divisible lane count (never below
    one lane per device) so each launch still rides the full mesh. Lanes
    are padded to a whole number of chunks by repeating the leading lanes
    (their results are discarded), so all launches share one compiled
    program.
    """
    import jax.numpy as jnp

    def _is_key(leaf):
        return jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key)

    def offload_tree(out):
        # typed PRNG-key leaves cannot become numpy (8 B/path threefry)
        # — keep them on device; everything else streams to host
        return jax.tree_util.tree_map(
            lambda leaf: leaf if _is_key(leaf) else jax.device_get(leaf),
            out,
        )

    if cap is None:
        if offload is True:
            # explicit offload with no chunking: still move the single
            # launch's output to host (frees device memory for whatever
            # runs next)
            return lambda *a: offload_tree(executor(*a))
        return executor
    if cap <= 0:
        raise ValueError(f"max_paths_per_launch must be positive; got {cap}")
    size = 1
    first_device = jax.devices()[0]
    if mesh is not None:
        size = dict(mesh.shape).get(PATHS_AXIS, mesh.devices.size)
        cap = max((cap // size) * size, size)
        first_device = mesh.devices.flat[0]

    def run(keys, x0s, target, config):
        K = keys.shape[0]
        if K <= cap:
            out = executor(keys, x0s, target, config)
            return offload_tree(out) if offload is True else out
        n_chunks = -(-K // cap)
        pad = n_chunks * cap - K
        if pad:
            keys = jnp.concatenate([keys, keys[:pad]])
            x0s = jnp.concatenate([x0s, x0s[:pad]])

        off = offload
        bufs = None  # preallocated K-row host buffers (None at key leaves)
        key_chunks = []  # per-chunk trees: key leaves on device, None else
        dev_outs = []  # whole chunk outputs when not offloading

        def store(c, out):
            # blocks on chunk c's transfer (the caller has already
            # dispatched chunk c+1, so compute and d2h overlap)
            nonlocal bufs
            if not off:
                dev_outs.append(out)
                return
            if bufs is None:
                # exact-K rows: no pad trim, no concat copy, 1× host peak
                bufs = jax.tree_util.tree_map(
                    lambda leaf: None if _is_key(leaf)
                    else np.empty((K,) + leaf.shape[1:], leaf.dtype),
                    out,
                )
            lo = c * cap
            rows = min(cap, K - lo)

            def put(buf, leaf):
                if buf is None:
                    return leaf  # key leaf: keep on device, concat later
                buf[lo : lo + rows] = np.asarray(
                    leaf if rows == cap else leaf[:rows]
                )
                return None

            key_chunks.append(
                jax.tree_util.tree_map(
                    put, bufs, out, is_leaf=lambda x: x is None
                )
            )

        pending = None  # (chunk index, its un-stored output)
        for c in range(n_chunks):
            out = executor(
                keys[c * cap : (c + 1) * cap],
                x0s[c * cap : (c + 1) * cap],
                target,
                config,
            )
            if off is None:
                # auto rule, decided once from the first chunk's CONCRETE
                # output avals (known at dispatch, no sync — the executor
                # may slim). Device memory is a per-device resource: a mesh
                # sharding the paths axis over `size` devices accumulates
                # 1/size of the bytes per device.
                chunk_bytes = sum(
                    leaf.size * leaf.dtype.itemsize
                    for leaf in jax.tree_util.tree_leaves(out)
                )
                limit = offload_auto_bytes(first_device)
                off = limit is not None and chunk_bytes * n_chunks > limit * size
            if pending is not None:
                store(c - 1, pending)
            pending = out
        store(n_chunks - 1, pending)

        if not off:
            full = jax.tree_util.tree_map(
                lambda *leaves: jnp.concatenate(leaves, axis=0), *dev_outs
            )
            if pad:
                full = jax.tree_util.tree_map(lambda leaf: leaf[:K], full)
            return full
        return jax.tree_util.tree_map(
            lambda buf, *chunks: (
                jnp.concatenate(chunks, axis=0)[:K] if buf is None else buf
            ),
            bufs,
            *key_chunks,
            is_leaf=lambda x: x is None,
        )

    return run


def make_path_executor(mesh: Optional[Mesh] = None):
    """Build ``executor(keys (K,), x0s (K, d), target, config) -> batched
    SinglePathState``.

    Without a mesh this is ``jit(vmap(core))`` on the default device; with a
    mesh the vmapped core is ``shard_map``-ped over the paths axis (K must be
    divisible by the mesh size — use :func:`pad_paths`).
    """
    def batched(keys, x0s, target, config):
        return jax.vmap(
            lambda k, x: pathfinder_core(k, x, target, config)
        )(keys, x0s)

    if mesh is None:
        return batched

    if DIM_AXIS in mesh.axis_names:
        # combined paths×dim layout (paths_dim_mesh): GSPMD, not
        # shard_map — the output pytree mixes leaves with the d axis in
        # different positions (x0s (K,d), traces (K,L+1,d), draws
        # (K,d,N)), which per-leaf out_specs would have to enumerate;
        # input sharding annotations instead let XLA place every
        # intermediate and insert the dim-axis reduction collectives.
        from jax.sharding import NamedSharding

        dim_width = dict(mesh.shape)[DIM_AXIS]

        def gspmd(keys, x0s, target, config):
            d = x0s.shape[1]
            if d % dim_width != 0:
                raise ValueError(
                    f"parameter dimension {d} is not divisible by the "
                    f"{dim_width}-wide '{DIM_AXIS}' mesh axis"
                )
            keys_s = jax.device_put(
                keys, NamedSharding(mesh, P(PATHS_AXIS))
            )
            x0s_s = jax.device_put(
                x0s, NamedSharding(mesh, P(PATHS_AXIS, DIM_AXIS))
            )
            return batched(keys_s, x0s_s, target, config)

        return gspmd

    def sharded(keys, x0s, target, config):
        fn = partial(batched, target=target, config=config)
        # check_vma=False: the optimizer's while_loop carries start replicated
        # (constants) and become device-varying — semantically fine here since
        # paths never communicate, but the static VMA check rejects it.
        try:
            shmapped = jax.shard_map(
                fn,
                mesh=mesh,
                in_specs=(P(PATHS_AXIS), P(PATHS_AXIS)),
                out_specs=P(PATHS_AXIS),
                check_vma=False,
            )
        except TypeError:  # older jax spelling
            shmapped = jax.shard_map(
                fn,
                mesh=mesh,
                in_specs=(P(PATHS_AXIS), P(PATHS_AXIS)),
                out_specs=P(PATHS_AXIS),
                check_rep=False,
            )
        return shmapped(keys, x0s)

    return sharded
