"""Result serialization round-trip tests (checkpoint/resume subsystem)."""

import numpy as np
import jax
import jax.numpy as jnp

from pathfinder_tpu.models import StandardNormal
from pathfinder_tpu.multipath import multipathfinder, resample
from pathfinder_tpu.singlepath import pathfinder
from pathfinder_tpu.utils.serialize import load_result, save_result


def test_singlepath_roundtrip(tmp_path):
    target = StandardNormal(4)
    res = pathfinder(target, key=jax.random.key(0), ndraws=20, maxiters=30)
    p = str(tmp_path / "single")
    save_result(p, res)
    loaded = load_result(p, fn=target)
    np.testing.assert_array_equal(np.asarray(loaded.draws), np.asarray(res.draws))
    assert loaded.fit_iteration == res.fit_iteration
    np.testing.assert_allclose(
        loaded.fit_distribution.mean, res.fit_distribution.mean
    )
    np.testing.assert_allclose(
        loaded.fit_distribution.cov.to_dense(),
        res.fit_distribution.cov.to_dense(),
    )
    # rebound log density works
    np.testing.assert_allclose(
        loaded.logp(jnp.zeros(4)), target.logp(jnp.zeros(4))
    )


def test_singlepath_roundtrip_cg_config(tmp_path):
    """Non-default optimizer config (optimizer="cg") survives the
    round-trip — the config string is part of the saved schema."""
    target = StandardNormal(4)
    res = pathfinder(target, key=jax.random.key(1), ndraws=20, maxiters=30,
                     optimizer="cg")
    p = str(tmp_path / "single_cg")
    save_result(p, res)
    loaded = load_result(p, fn=target)
    assert loaded.config.optimizer == "cg"
    np.testing.assert_array_equal(
        np.asarray(loaded.draws), np.asarray(res.draws)
    )


def test_multipath_roundtrip_and_resample(tmp_path):
    target = StandardNormal(3)
    res = multipathfinder(
        target, 60, key=jax.random.key(1), nruns=4, maxiters=30
    )
    p = str(tmp_path / "multi")
    save_result(p, res)
    loaded = load_result(p, fn=target)
    np.testing.assert_array_equal(np.asarray(loaded.draws), np.asarray(res.draws))
    np.testing.assert_allclose(
        np.asarray(loaded.psis_result.weights),
        np.asarray(res.psis_result.weights),
    )
    # post-hoc resample works on the loaded result (the reference's
    # resample-on-stored-result feature, now across sessions)
    r2 = resample(loaded, 40, key=jax.random.key(2))
    assert r2.draws.shape == (3, 40)
    r2b = resample(res, 40, key=jax.random.key(2))
    np.testing.assert_array_equal(np.asarray(r2.draws), np.asarray(r2b.draws))


def test_schema_evolution_tolerant_load(tmp_path):
    """Files written by other versions load with warnings, not TypeErrors:
    renamed-away fields are dropped, newer fields fill from defaults/None."""
    import json
    import numpy as np_
    import pytest

    target = StandardNormal(3)
    res = pathfinder(target, key=jax.random.key(0), ndraws=10, maxiters=20)
    p = str(tmp_path / "evo")
    save_result(p, res)

    data = dict(np_.load(p + ".npz", allow_pickle=False))
    meta = json.loads(bytes(data["__meta__"]).decode())
    assert meta["v"] == 1
    root = meta["root"]
    assert root["type"] == "PathfinderResult"
    # simulate an old file: a field the current class does not have, and a
    # current field missing from the file
    root["fields"]["legacy_field"] = {"lit": 42}
    removed = "num_tries"
    assert removed in root["fields"]
    del root["fields"][removed]
    data["__meta__"] = np_.frombuffer(
        json.dumps(meta).encode(), dtype=np_.uint8
    )
    np_.savez(p + "_old", **data)

    with pytest.warns(UserWarning, match="legacy_field"):
        loaded = load_result(p + "_old", fn=target)
    np_.testing.assert_array_equal(
        np_.asarray(loaded.draws), np_.asarray(res.draws)
    )


def test_roundtrip_bayes_model_result(tmp_path):
    """Transform-aware (BayesModel) results round-trip: load_result(fn=model)
    resolves the linked density (regression: it used to raise TypeError),
    named-chain dicts are serialized, the pushforward fit distribution is
    rebuilt, and resample works on the loaded result warning-free."""
    import warnings

    import jax.numpy as jnp

    from pathfinder_tpu import multipathfinder
    from pathfinder_tpu.models.bayes import BayesModel, HalfNormal, Normal
    from pathfinder_tpu.multipath import resample

    obs = jnp.asarray([1.0, 2.0, 0.5])
    model = BayesModel(
        {"mu": Normal(0.0, 5.0), "sigma": HalfNormal(2.0)},
        loglikelihood=lambda p: jnp.sum(
            -0.5 * ((obs - p["mu"]) / p["sigma"]) ** 2 - jnp.log(p["sigma"])
        ),
    )
    res = multipathfinder(model, 100, key=jax.random.key(0), nruns=4, maxiters=40)
    p = str(tmp_path / "bayes_run")
    save_result(p, res)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loaded = load_result(p, fn=model)

    for k in res.draws_transformed:
        np.testing.assert_allclose(
            np.asarray(loaded.draws_transformed[k]),
            np.asarray(res.draws_transformed[k]),
        )
    draws_c, _ = res.fit_distribution_transformed.sample(jax.random.key(9), 7)
    np.testing.assert_allclose(
        np.asarray(loaded.fit_distribution_transformed.logpdf(draws_c)),
        np.asarray(res.fit_distribution_transformed.logpdf(draws_c)),
        rtol=1e-6,
    )
    r2 = resample(loaded, 50)
    r2b = resample(res, 50)
    np.testing.assert_array_equal(np.asarray(r2.draws), np.asarray(r2b.draws))
    assert np.all(np.asarray(r2.draws_transformed["sigma"]) > 0)


def test_bfloat16_leaves_roundtrip_exactly(tmp_path):
    """ml_dtypes leaves (bfloat16 etc., numpy kind 'V') must round-trip
    bit-exactly — np.savez alone would store them as dtype-less raw bytes
    that load as '|V2' garbage."""
    import ml_dtypes

    target = StandardNormal(4)
    res = pathfinder(target, key=jax.random.key(0), ndraws=8, maxiters=20)
    import dataclasses

    vals = jnp.asarray(
        np.linspace(-3.0, 3.0, res.draws.size).reshape(res.draws.shape),
        ml_dtypes.bfloat16,
    )
    res_bf = dataclasses.replace(res, draws=vals)
    p = str(tmp_path / "bf16")
    save_result(p, res_bf)
    loaded = load_result(p, fn=target)
    assert loaded.draws.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(loaded.draws, np.float32), np.asarray(vals, np.float32)
    )


def test_unregistered_root_raises_at_save_time(tmp_path):
    """Saving an unserializable root must fail loudly at save time, not
    write a file that loads as None."""
    import pytest

    with pytest.raises(TypeError, match="not a serializable"):
        save_result(str(tmp_path / "bad"), lambda x: x)
    with pytest.raises(TypeError, match="not a serializable"):
        save_result(str(tmp_path / "bad2"), object())


def test_orbax_roundtrip_matches_npz(tmp_path):
    """The orbax checkpoint path (device-array sibling of save_result)
    round-trips a multipath result identically to the npz path, including
    post-hoc resample on the loaded result."""
    from pathfinder_tpu.utils.serialize import (
        load_result_orbax,
        save_result_orbax,
    )

    target = StandardNormal(3)
    res = multipathfinder(
        target, 60, key=jax.random.key(1), nruns=4, maxiters=30
    )
    p = str(tmp_path / "multi_orbax")
    save_result_orbax(p, res)
    loaded = load_result_orbax(p, fn=target)
    np.testing.assert_array_equal(
        np.asarray(loaded.draws), np.asarray(res.draws)
    )
    np.testing.assert_allclose(
        np.asarray(loaded.psis_result.weights),
        np.asarray(res.psis_result.weights),
    )
    np.testing.assert_allclose(
        np.asarray(loaded.fit_distribution.component(0).cov.to_dense()),
        np.asarray(res.fit_distribution.component(0).cov.to_dense()),
    )
    r2 = resample(loaded, 40, key=jax.random.key(2))
    r2b = resample(res, 40, key=jax.random.key(2))
    np.testing.assert_array_equal(np.asarray(r2.draws), np.asarray(r2b.draws))
    # same loud save-time failure contract as save_result
    import pytest

    with pytest.raises(TypeError, match="not a serializable"):
        save_result_orbax(str(tmp_path / "bad_orbax"), object())


def test_orbax_saves_mesh_sharded_arrays(tmp_path):
    """Arrays sharded over a device mesh checkpoint through orbax without
    a host gather (the reason this path exists) and restore equal."""
    import dataclasses

    from jax.sharding import NamedSharding, PartitionSpec
    from pathfinder_tpu.parallel.sharding import paths_mesh
    from pathfinder_tpu.utils.serialize import (
        load_result_orbax,
        save_result_orbax,
    )

    target = StandardNormal(3)
    res = pathfinder(target, key=jax.random.key(0), ndraws=16, maxiters=30)
    mesh = paths_mesh(jax.devices()[:4])
    sharded_draws = jax.device_put(
        res.draws,
        NamedSharding(mesh, PartitionSpec(None, mesh.axis_names[0])),
    )
    assert not sharded_draws.is_fully_replicated
    res_sharded = dataclasses.replace(res, draws=sharded_draws)
    p = str(tmp_path / "sharded_orbax")
    save_result_orbax(p, res_sharded)
    loaded = load_result_orbax(p, fn=target)
    np.testing.assert_array_equal(
        np.asarray(loaded.draws), np.asarray(res.draws)
    )


def test_orbax_bfloat16_leaves_roundtrip(tmp_path):
    """ml_dtypes leaves round-trip natively through TensorStore (no f32
    upcast detour needed on this path)."""
    import dataclasses

    import ml_dtypes

    from pathfinder_tpu.utils.serialize import (
        load_result_orbax,
        save_result_orbax,
    )

    target = StandardNormal(4)
    res = pathfinder(target, key=jax.random.key(0), ndraws=8, maxiters=20)
    vals = jnp.asarray(
        np.linspace(-3.0, 3.0, res.draws.size).reshape(res.draws.shape),
        ml_dtypes.bfloat16,
    )
    res_bf = dataclasses.replace(res, draws=vals)
    p = str(tmp_path / "bf16_orbax")
    save_result_orbax(p, res_bf)
    loaded = load_result_orbax(p, fn=target)
    assert loaded.draws.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(loaded.draws, np.float32), np.asarray(vals, np.float32)
    )


def test_type_registry_is_a_mapping():
    """``TYPE_REGISTRY`` is exported as a mapping (PEP 562 lazy build): the
    documented extension/introspection point must be subscriptable."""
    from pathfinder_tpu.utils.serialize import TYPE_REGISTRY

    assert "MvNormal" in TYPE_REGISTRY
    from pathfinder_tpu.ops.mvnormal import MvNormal

    assert TYPE_REGISTRY["MvNormal"] is MvNormal


def test_laplace_corrected_result_roundtrip(tmp_path):
    """A laplace_resample-corrected result round-trips: the corrected
    components carry zero-size low-rank parts (B of shape (d, 0)) that the
    npz encoder must preserve, and a chained resample on the loaded result
    matches the in-memory one."""
    from pathfinder_tpu.multipath import laplace_resample

    target = StandardNormal(3)
    res = multipathfinder(
        target, 60, key=jax.random.key(1), nruns=4, maxiters=30
    )
    corrected = laplace_resample(res, 50, method="diag")
    assert corrected.fit_distribution.components.cov.B.shape[-1] == 0
    p = str(tmp_path / "laplace")
    save_result(p, corrected)
    loaded = load_result(p, fn=target)
    np.testing.assert_array_equal(
        np.asarray(loaded.draws), np.asarray(corrected.draws)
    )
    assert loaded.fit_distribution.components.cov.B.shape[-1] == 0
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda c: c.cov.diag())(
            loaded.fit_distribution.components
        )),
        np.asarray(jax.vmap(lambda c: c.cov.diag())(
            corrected.fit_distribution.components
        )),
    )
    a = resample(loaded, 30, key=jax.random.key(5))
    b = resample(corrected, 30, key=jax.random.key(5))
    np.testing.assert_array_equal(np.asarray(a.draws), np.asarray(b.draws))
