"""The GPU smoke run's CPU-checkable parts: the device gate, the contracted
last line, the compile-cache choice, the float64 L-BFGS reference, its
phases at toy sizes, and the mesh comparisons it shares with the CPU dry
run. The ``gpu`` test runs the operator phase on a real card."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu_card():
    """Skip unless JAX's default device is a CUDA GPU (decided here, not
    at import, so every test worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU; JAX's default device is "
                    f"{jax.devices()[0].platform}")
    return chip_smoke.card_names()[0]


def test_device_gate_exits_nonzero_on_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(1)
    assert exc.value.code not in (0, None)
    assert "needs a CUDA GPU" in str(exc.value.code)


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a CUDA GPU" in proc.stderr


def test_bench_refuses_to_measure_without_gpu():
    import bench

    with pytest.raises(SystemExit) as exc:
        bench.device_info()
    assert exc.value.code not in (0, None)


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_is_the_contract(count):
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev] * count)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": count},
    }
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", "kind": '
        f'"NVIDIA H100 80GB HBM3", "count": {count}}}}}'
    )


def test_compile_cache_dir_honours_jax_variable():
    assert compile_cache.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}
    ) == "/elsewhere/cache"
    path = compile_cache.compile_cache_dir({})
    assert path == os.path.join(ROOT, ".jax_cache")
    # an empty variable is unset
    assert compile_cache.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": ""}) == path


def test_use_compile_cache_sets_nothing_when_jax_variable_is_set(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.use_compile_cache() == "/elsewhere/cache"
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert compile_cache.use_compile_cache() == compile_cache.DEFAULT_DIR
    assert calls == [("jax_compilation_cache_dir", compile_cache.DEFAULT_DIR)]
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("m", [0, 1, 3])
def test_dense_inverse_hessian_reference_matches_package(m):
    """The smoke's float64 L-BFGS reference agrees with the package's
    Woodbury-form rebuild in float64 at every trajectory point,
    including the first points' partial windows (m = history length)."""
    from pathfinder_tpu.ops.lbfgs import (
        lbfgs_inverse_hessians,
        minimize_lbfgs_trace,
    )

    d = 12
    prec = jnp.asarray(np.linspace(0.5, 20.0, d))
    trace = minimize_lbfgs_trace(
        jax.value_and_grad(lambda x: -0.5 * jnp.sum(prec * x * x)),
        jnp.linspace(-2.0, 2.0, d), maxiters=20,
        history_length=max(m, 1),
    )
    nv = int(trace.num_valid)
    H_ref = chip_smoke._dense_inverse_hessians(
        trace.xs, trace.gradients, nv, max(m, 1), 1e-12
    )
    fits, _, _ = lbfgs_inverse_hessians(trace, history_length=max(m, 1))
    dense = np.asarray(jax.vmap(lambda w: w.to_dense())(fits))[:nv]
    assert nv > 3
    np.testing.assert_allclose(dense, H_ref, rtol=1e-9, atol=1e-12)


def test_headline_and_k1000_phases_at_toy_size(capsys):
    """The headline and 1000-path phases run end to end on the CPU at toy
    sizes (the default device is the CPU here, so the GPU-vs-CPU
    comparison compares the CPU with itself)."""
    with jax.enable_x64(False):
        repeated_identical = chip_smoke.headline_phase(
            "cpu", d=20, nruns=4, seeds=(0, 1)
        )
        chip_smoke.k1000_phase("cpu", d=20, K=8)
    out = capsys.readouterr().out
    assert repeated_identical
    assert out.count("[headline] key=") == 5
    assert "4/4 succeeded" in out and "success equal=True" in out
    assert "[k1000] 8/8 succeeded, finite draws=True" in out
    assert "memory_analysis" in out


def test_check_meshes_on_four_virtual_cpu_devices(capsys):
    """The mesh comparisons shared with ``chip_smoke.py --four-gpus`` pass
    with bit-identical floats on four virtual CPU devices."""
    from __graft_entry__ import check_meshes

    devices = jax.devices()[:4]
    assert len(devices) == 4
    with jax.enable_x64(False):
        errors = check_meshes(devices)
    assert "mesh checks OK: 8 paths at d=16 over 4 devices" in (
        capsys.readouterr().out
    )
    assert errors["paths_mesh draws"] == 0.0
    assert errors["paths_mesh khat"] == 0.0


def test_mesh_compare_tiers():
    from __graft_entry__ import _Compare

    exact = _Compare(rtol=None)
    exact.floats("same", np.ones(3), np.ones(3))
    exact.floats("batch width", np.ones(3) + 1e-7, np.ones(3), cpu_atol=1e-6)
    exact.check()
    exact.floats("ulp", np.ones(3) + 1e-7, np.ones(3))
    with pytest.raises(AssertionError, match="ulp: .*relative error"):
        exact.check()

    tol = _Compare(rtol=1e-3)
    tol.floats("rounding", np.full(3, 2.0 + 1e-4), np.full(3, 2.0))
    assert tol.errors["rounding"] == pytest.approx(5e-5)
    tol.exact("decisions", np.array([1, 2]), np.array([1, 2]))
    tol.check()
    tol.diverging("chaotic", np.array([1.0, 2.0]), np.array([1.0, 5.0]))
    assert tol.diverged["chaotic"] == (1, 2)
    tol.check()
    tol.diverging("chaotic nan", np.array([np.nan]), np.array([1.0]))
    exact.diverging("chaotic on cpu", np.array([1.0]), np.array([1.5]))
    with pytest.raises(AssertionError, match="chaotic on cpu: sharded differs"):
        exact.check()
    with pytest.raises(AssertionError) as exc:
        tol.check()
    msg = str(exc.value)
    assert "chaotic nan: non-finite" in msg
    tol.floats("too far", np.full(3, 2.01), np.full(3, 2.0))
    tol.floats("nan", np.array([np.nan]), np.array([1.0]))
    tol.exact("ids", np.array([1, 2]), np.array([1, 3]))
    with pytest.raises(AssertionError) as exc:
        tol.check()
    msg = str(exc.value)
    assert "too far: " in msg and "nan: non-finite" in msg
    assert "ids: sharded differs from unsharded at 1 of 2" in msg


@pytest.mark.gpu
def test_operator_phase_on_gpu(gpu_card):
    with jax.enable_x64(False):
        worst = chip_smoke.operators_phase(gpu_card)
    assert worst["default"] <= chip_smoke.OPERATOR_RTOL
