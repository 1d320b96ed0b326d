"""The automatic host-offload threshold of chunked launches is derived from
the device's memory limit (``parallel.sharding.offload_auto_bytes``)."""

from types import SimpleNamespace

import pytest

from pathfinder_tpu.parallel import sharding


def _device(stats):
    return SimpleNamespace(memory_stats=lambda: stats)


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_no_threshold_without_a_memory_limit(stats):
    assert sharding.offload_auto_bytes(_device(stats)) is None


def test_threshold_is_the_stated_fraction_of_the_limit():
    limit = 60 << 30
    assert sharding.OFFLOAD_AUTO_FRACTION == 1 / 8
    assert sharding.offload_auto_bytes(
        _device({"bytes_limit": limit, "bytes_in_use": 123})
    ) == int(limit * sharding.OFFLOAD_AUTO_FRACTION)


def test_explicit_bytes_replace_the_derived_threshold(monkeypatch):
    monkeypatch.setattr(sharding, "OFFLOAD_AUTO_BYTES", 4096)
    assert sharding.offload_auto_bytes(_device(None)) == 4096
    assert sharding.offload_auto_bytes(_device({"bytes_limit": 1 << 40})) == 4096


def test_cpu_backend_never_offloads_automatically():
    import jax

    assert jax.devices()[0].memory_stats() is None
    assert sharding.offload_auto_bytes(jax.devices()[0]) is None
