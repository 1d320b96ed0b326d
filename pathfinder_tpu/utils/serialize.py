"""Result serialization: save/load Pathfinder results without re-running.

The reference has no checkpointing; its closest feature is post-hoc
``resample`` on a stored in-session result (``src/resample.jl:20-46``),
enabled by results retaining everything. Here results are pytrees, so we go
further (new scope flagged in SURVEY §5): any result round-trips through one
``.npz`` file containing a self-describing JSON structure plus the array
leaves. Callables (the log density, user input objects) are not serialized —
pass ``fn=`` at load time to re-bind them; everything needed by
``resample``, ``WoodburyMetric``, and draw analysis is restored.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "save_result",
    "load_result",
    "save_result_orbax",
    "load_result_orbax",
    "TYPE_REGISTRY",
]


def __getattr__(name):
    # TYPE_REGISTRY is the name -> class mapping of serializable node types.
    # It must be built lazily (the classes live in modules that import this
    # package), so expose it via PEP 562 instead of a module constant.
    if name == "TYPE_REGISTRY":
        return _registry()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@functools.lru_cache(maxsize=1)
def _registry():
    from pathfinder_tpu.multipath import MultiPathfinderResult
    from pathfinder_tpu.ops.elbo import ELBOEstimate
    from pathfinder_tpu.ops.lbfgs import OptimizationTrace
    from pathfinder_tpu.ops.mvnormal import MvNormal, UniformMixture
    from pathfinder_tpu.ops.psis import PSISResult
    from pathfinder_tpu.ops.woodbury import WoodburyFactor, WoodburyPDMat
    from pathfinder_tpu.singlepath import (
        PathfinderConfig,
        PathfinderResult,
        SinglePathState,
    )

    return {
        cls.__name__: cls
        for cls in [
            MultiPathfinderResult,
            PathfinderResult,
            PathfinderConfig,
            SinglePathState,
            OptimizationTrace,
            ELBOEstimate,
            MvNormal,
            UniformMixture,
            WoodburyFactor,
            WoodburyPDMat,
            PSISResult,
        ]
    }


def _field_items(obj):
    if dataclasses.is_dataclass(obj):
        return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    if hasattr(obj, "_fields"):  # NamedTuple
        return list(zip(obj._fields, obj))
    return None


def _encode(obj, arrays: dict, counter: list, device_leaves: bool = False):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"lit": obj}
    if isinstance(obj, jax.Array) and jnp.issubdtype(
        obj.dtype, jax.dtypes.prng_key
    ):
        aid = f"a{counter[0]}"
        counter[0] += 1
        kd = jax.random.key_data(obj)
        arrays[aid] = kd if device_leaves else np.asarray(kd)
        return {"key": aid}
    if isinstance(obj, (jax.Array, np.ndarray, np.generic)):
        aid = f"a{counter[0]}"
        counter[0] += 1
        node = {"arr": aid}
        if device_leaves and isinstance(obj, jax.Array):
            # orbax/TensorStore writes device (possibly sharded) arrays
            # directly — no host gather, and ml_dtypes round-trip natively
            arrays[aid] = obj
            return node
        arr = np.asarray(obj)
        if arr.dtype.kind == "V":
            # ml_dtypes (bfloat16 / float8_*) have numpy kind 'V':
            # np.savez would write dtype-less raw bytes that load as
            # '|V2' garbage. Store a lossless float32 upcast (exact for
            # every <=16-bit ml float) plus the original dtype name.
            node["dt"] = arr.dtype.name
            arr = arr.astype(np.float32)
        arrays[aid] = arr
        return node
    items = _field_items(obj)
    if items is not None and type(obj).__name__ in _registry():
        return {
            "type": type(obj).__name__,
            "fields": {
                k: _encode(v, arrays, counter, device_leaves)
                for k, v in items
            },
        }
    if isinstance(obj, (list, tuple)):
        return {
            "seq": [_encode(v, arrays, counter, device_leaves) for v in obj],
            "tuple": isinstance(obj, tuple),
        }
    if isinstance(obj, dict) and all(isinstance(k, str) for k in obj):
        # named-chain dicts (draws_transformed of model runs) round-trip
        return {
            "map": {
                k: _encode(v, arrays, counter, device_leaves)
                for k, v in obj.items()
            }
        }
    # callables / unknown objects: recorded as skipped
    return {"skip": repr(type(obj))}


def _decode(meta, arrays, rebind: dict, unbound: set):
    if "lit" in meta:
        return meta["lit"]
    if "arr" in meta:
        out = jnp.asarray(arrays[meta["arr"]])
        if "dt" in meta:  # restore an ml_dtypes leaf (see _encode)
            out = out.astype(meta["dt"])
        return out
    if "key" in meta:
        return jax.random.wrap_key_data(jnp.asarray(arrays[meta["key"]]))
    if "seq" in meta:
        vals = [_decode(v, arrays, rebind, unbound) for v in meta["seq"]]
        return tuple(vals) if meta.get("tuple") else vals
    if "map" in meta:
        return {
            k: _decode(v, arrays, rebind, unbound)
            for k, v in meta["map"].items()
        }
    if "skip" in meta:
        return None
    if "type" in meta:
        cls = _registry()[meta["type"]]
        fields = {
            k: _decode(v, arrays, rebind, unbound)
            for k, v in meta["fields"].items()
        }
        for k, v in meta["fields"].items():
            if "skip" in v and fields[k] is None and k not in rebind:
                unbound.add(f"{meta['type']}.{k}")
        for k, v in rebind.items():
            if k in fields and fields[k] is None:
                fields[k] = v
        return _construct(cls, fields, meta["type"])
    raise ValueError(f"bad meta node: {meta}")


def _construct(cls, fields: dict, type_name: str):
    """Schema-evolution-tolerant construction: fields saved by an older
    version that no longer exist are dropped, fields added since are filled
    from the dataclass/NamedTuple default (or ``None``) — both with a
    warning naming the field, so renames surface loudly instead of as an
    opaque ``TypeError``."""
    import warnings

    if dataclasses.is_dataclass(cls):
        current = {f.name: f for f in dataclasses.fields(cls)}
        defaults = {
            n: (
                f.default
                if f.default is not dataclasses.MISSING
                else f.default_factory()
            )
            for n, f in current.items()
            if f.default is not dataclasses.MISSING
            or f.default_factory is not dataclasses.MISSING
        }
    else:  # NamedTuple
        current = dict.fromkeys(cls._fields)
        defaults = dict(cls._field_defaults)

    dropped = sorted(set(fields) - set(current))
    added = sorted(set(current) - set(fields))
    if dropped:
        warnings.warn(
            f"load_result: saved {type_name} has fields the current class "
            f"does not: {dropped}; dropping them (file written by another "
            "version)."
        )
    kwargs = {k: v for k, v in fields.items() if k in current}
    for name in added:
        kwargs[name] = defaults.get(name)
    if added and any(n not in defaults for n in added):
        warnings.warn(
            f"load_result: saved {type_name} predates fields "
            f"{[n for n in added if n not in defaults]}; filled with None."
        )
    return cls(**kwargs)


FORMAT_VERSION = 1


def save_result(path: str, result) -> None:
    """Save any registered result/state pytree to ``<path>.npz``."""
    arrays: dict = {}
    root = _encode(result, arrays, [0])
    _check_root(root, result, "save_result")
    meta = {"v": FORMAT_VERSION, "root": root}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez(path, **arrays)


def _check_root(root, result, what: str):
    if "skip" in root:
        # an unregistered root would write a file that loads as None with
        # no warning (the unbound-fields check only sees fields of
        # registered types) — refuse loudly at save time instead
        raise TypeError(
            f"{what}: {type(result).__name__} is not a serializable "
            "result type (register it in TYPE_REGISTRY, or save a "
            "PathfinderResult/MultiPathfinderResult/SinglePathState)"
        )


def save_result_orbax(path: str, result) -> None:
    """Save a result as an orbax/TensorStore checkpoint DIRECTORY.

    The device-array sibling of :func:`save_result` (same meta schema, same
    :func:`load-time <load_result>` re-binding semantics): device arrays —
    including arrays **sharded over a mesh** — are written by orbax without
    a host gather, so a multipath result whose draws live distributed
    across devices checkpoints without pulling the pool through the host
    (at d=10⁶ the draw matrix alone is 400 MB/path-pool). Requires
    ``orbax-checkpoint``; ``path`` must not already exist.
    """
    import orbax.checkpoint as ocp

    arrays: dict = {}
    root = _encode(result, arrays, [0], device_leaves=True)
    _check_root(root, result, "save_result_orbax")
    meta = {"v": FORMAT_VERSION, "root": root}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    ).copy()  # frombuffer views are read-only; orbax requires writable
    ckptr = ocp.StandardCheckpointer()
    try:
        ckptr.save(os.path.abspath(path), arrays)
        ckptr.wait_until_finished()
    finally:
        ckptr.close()


def load_result_orbax(path: str, fn=None):
    """Load a checkpoint written by :func:`save_result_orbax`.

    ``fn`` re-binds callable fields exactly as in :func:`load_result`.
    Arrays are restored to host and converted lazily by the decode step;
    pass the result through ``jax.device_put`` with shardings to
    re-distribute.
    """
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    try:
        data = ckptr.restore(os.path.abspath(path))
    finally:
        ckptr.close()
    meta = json.loads(bytes(np.asarray(data.pop("__meta__"))).decode())
    return _decode_with_rebind(meta["root"], data, fn)


def load_result(path: str, fn=None):
    """Load a result saved by :func:`save_result`.

    ``fn``: the original target (callable, :class:`LogDensity`, model with a
    ``.transformed`` link such as ``BayesModel``, or
    ``TransformedLogDensity``); when given, ``logp``/``target``/``input``
    (and ``transform`` for model inputs) are re-bound so importance
    re-resampling works on the loaded result.
    """
    path = os.fspath(path)  # accept pathlib.Path like np.load does
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["__meta__"]).decode())
    # pre-versioning files hold the root node directly
    meta = meta["root"] if "v" in meta else meta
    return _decode_with_rebind(meta, data, fn)


def _decode_with_rebind(meta, arrays, fn):
    """Shared load tail: decode the meta tree against the array store and
    re-bind callable fields from ``fn`` (see :func:`load_result`)."""
    rebind = {}
    if fn is not None:
        from pathfinder_tpu.integrations.transforms import resolve_transform
        from pathfinder_tpu.models.protocol import as_log_density

        # model inputs (BayesModel / TransformedLogDensity) resolve to their
        # unconstrained linked density — the space the stored draws live in
        target_input, tld = resolve_transform(fn, None)
        target = as_log_density(target_input)
        rebind = {"logp": target.logp, "target": target, "input": fn}
        if tld is not None:
            rebind["transform"] = tld
    unbound: set = set()
    result = _decode(meta, arrays, rebind, unbound)
    if (
        "transform" in rebind
        and getattr(result, "fit_distribution_transformed", False) is None
        and getattr(result, "fit_distribution", None) is not None
    ):
        # the pushforward fit distribution holds the (unserialized) bijector;
        # rebuild it from the rebound transform
        from pathfinder_tpu.integrations.transforms import (
            TransformedDistribution,
        )

        result = dataclasses.replace(
            result,
            fit_distribution_transformed=TransformedDistribution(
                result.fit_distribution, rebind["transform"].bijector
            ),
        )
        unbound.discard(f"{type(result).__name__}.fit_distribution_transformed")
    if unbound:
        import warnings

        warnings.warn(
            "load_result: callable fields were not serialized and were not "
            f"re-bound: {sorted(unbound)}. Pass `fn=` (the original target) "
            "to restore them, or resample()/elbo_estimates will fail."
        )
    return result
